"""LM substrate: configs, layers and the dense family, with the zoo API."""
