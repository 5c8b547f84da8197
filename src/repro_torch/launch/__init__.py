"""Step factories of the transformer stack on one device (no mesh)."""
