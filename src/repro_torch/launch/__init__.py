"""Entry points of the port: ``serve`` (batched prefill + decode of an LM card)."""
