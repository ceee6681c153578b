"""STEREODPNET_PLUS: the serving configuration of StereoDPNet."""
