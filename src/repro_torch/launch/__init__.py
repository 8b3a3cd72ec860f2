"""Step functions and entry points of the port: serving and training."""
