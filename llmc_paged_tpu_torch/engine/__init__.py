"""The serving engine and its scheduler."""
