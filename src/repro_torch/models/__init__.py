"""The LM stack of the port (dense family): layers, attention with the
flash route onto the hand-written SWA kernel, and the layer-stack model."""
