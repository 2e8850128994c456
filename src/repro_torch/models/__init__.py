"""Layers, the layer stack and the model facade of the port."""
