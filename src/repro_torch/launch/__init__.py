"""Entry points: the serving CLI."""
