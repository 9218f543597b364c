"""Launch layer of the port: the training and serving launchers
(``launch.train``, ``launch.serve``), the meshes of sharded runs
(``launch.mesh.make_mesh`` / ``make_production_mesh``) and the replica
device groups of multi-replica serving (``launch.mesh.replica_groups``)."""
