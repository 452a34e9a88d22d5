"""Models of the port: GPT (decoder-only transformer), BERT (encoder),
Transformer NMT (encoder-decoder with beam search), ResNet (the ImageNet
CNN, with the fused 1x1 path) and shared blocks."""
