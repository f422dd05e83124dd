"""Models of the port: the paper's MLP classifier and the dense LLM stack."""
