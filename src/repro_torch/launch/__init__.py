"""Launch layer of the port: meshes and sharding rules (``mesh``,
``sharding``), serve and train step factories, and the serving and
training launchers; the dry run of every (arch x shape x mesh) cell,
counted from the placements (``dryrun``), the roofline on the H100's
figures (``roofline``) and the analytic FLOP and HBM-traffic models it
reads (``analytic``). Importing the package imports none of them."""
