"""Measurement probes that run on the card (``python -m
fora_tpu_torch.probes.<name>``)."""
