"""Backbones, fusion stack, the composed ``JMTModel`` and the weight
carrier from the JAX package (``convert.py``)."""
