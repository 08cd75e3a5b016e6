"""Launch layer of the port: meshes and sharding rules (``mesh``,
``sharding``), serve and train step factories, and the serving and
training launchers."""
