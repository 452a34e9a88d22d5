"""Models of the port: GPT (decoder-only transformer), BERT (encoder)
and shared blocks."""
