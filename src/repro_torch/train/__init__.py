"""Training and serving steps, and the training loop (counterpart of
``repro.train``)."""
