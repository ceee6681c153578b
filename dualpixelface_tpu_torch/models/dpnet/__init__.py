"""DPNet: the encoder-decoder of the dual-pixel pair, five depth heads."""
