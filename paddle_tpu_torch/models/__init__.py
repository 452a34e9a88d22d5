"""Models of the port: GPT (decoder-only transformer), BERT (encoder),
Transformer NMT (encoder-decoder with beam search), ResNet (the ImageNet
CNN, with the fused 1x1 path), VGG-16 (the inference benchmark CNN) and
shared blocks, among them the int8 conv path both CNNs serve with."""

from . import bert, lenet, resnet, vgg  # noqa: F401
