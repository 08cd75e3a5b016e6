"""Model definitions of the port: config, layers, attention and the dense
decoder assembly."""
