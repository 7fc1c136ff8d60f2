"""Launchers: the process grid of the distributed solve and its check CLI."""
