"""Models of the port: the paper's 2NN MLP."""
