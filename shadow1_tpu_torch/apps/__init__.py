"""Model applications of the port's net model."""
