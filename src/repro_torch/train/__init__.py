"""The fault-tolerant training loop and ``python -m repro_torch.train``
(port of ``repro.train`` and the reference's training example)."""
