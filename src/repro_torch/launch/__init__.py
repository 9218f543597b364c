"""Launch layer of the port: the replica device groups
(``launch.mesh.replica_groups``) of multi-replica serving."""
