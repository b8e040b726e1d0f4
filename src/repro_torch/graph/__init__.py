"""Graph substrate of the port (numpy generators)."""
