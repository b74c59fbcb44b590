"""Launchers: the serving entry point on the card."""
