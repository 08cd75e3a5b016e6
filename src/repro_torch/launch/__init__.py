"""Launch layer of the port: serve step factories and the serving
launcher."""
