"""The reference's ``examples/`` on the port: run each as
``python -m repro_torch.examples.<name>`` (``--device cpu`` off the card)."""
