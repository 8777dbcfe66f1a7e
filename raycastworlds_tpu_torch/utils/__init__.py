"""Tools of the port: checkpoints."""
