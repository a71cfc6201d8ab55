"""GPT-2: the dense model and its paged serving paths."""
