"""Query sources and accuracy metrics (host numpy), as ``fora_tpu.eval``."""
