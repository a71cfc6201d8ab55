"""Paged KV pool (device side) and block manager (host side)."""
