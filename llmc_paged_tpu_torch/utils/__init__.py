"""Shared utilities of the port: the token-stream DataLoader."""
