"""Entry points of the port: ``train_fmnist`` (the paper's experiment) and
``train_wire`` (the same step with the full Table-1 wire)."""
