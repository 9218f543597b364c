"""Launch layer of the port: the training and serving launchers
(``launch.train``, ``launch.serve``) and the replica device groups
(``launch.mesh.replica_groups``) of multi-replica serving."""
