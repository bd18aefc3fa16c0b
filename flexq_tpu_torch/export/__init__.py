"""Packed checkpoints: the exporter's format v2 and the safetensors files
it is made of."""
