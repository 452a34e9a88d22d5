"""Models of the port: GPT (decoder-only transformer) and shared blocks."""
