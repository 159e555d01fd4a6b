"""Acceptance-limit engines."""
