"""The SSD training loss."""
