"""Configuration, corpus IO and the CUDA build."""
