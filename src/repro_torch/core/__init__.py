"""Core of the port: PRNG chain, direction families, projection, rounds."""
