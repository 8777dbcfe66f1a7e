"""World families of the port."""
