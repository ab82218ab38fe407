"""Entry points of the port: ``train_fmnist`` (the paper's experiment)."""
