"""Examples of the port's library surface, run as modules
(``python -m altro_tpu_torch.examples.<name>``)."""
