"""Entry points of the port: ``train_fmnist`` (the paper's experiment),
``train_wire`` (the same step with the full Table-1 wire), and ``train``
with its step factories ``steps`` (the zoo LM with TT weight sites)."""
