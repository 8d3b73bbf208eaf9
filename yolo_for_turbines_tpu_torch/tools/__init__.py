"""Command-line tools of the PyTorch port."""
