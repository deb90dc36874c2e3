"""Models of the port: the codebook and the classification step."""
