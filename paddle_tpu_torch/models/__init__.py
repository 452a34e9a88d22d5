"""Models of the port: GPT (decoder-only transformer), BERT (encoder),
Transformer NMT (encoder-decoder with beam search) and shared blocks."""
