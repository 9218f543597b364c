"""Launch layer of the port: the training and serving launchers
(``launch.train``, ``launch.serve``), the meshes of sharded runs
(``launch.mesh.make_mesh`` / ``make_production_mesh``), the replica
device groups of multi-replica serving (``launch.mesh.replica_groups``)
and the dry-run tools (``launch.dryrun`` / ``dryrun_all`` over
``specs``, ``op_cost``, the counterpart of the reference's ``hlo_cost``,
and ``analysis``)."""
