"""Device setup and output persistence of the port."""
