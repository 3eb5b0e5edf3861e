"""Generative inference: engine and sampling."""
