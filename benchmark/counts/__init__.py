"""Frozen work counts and card peaks."""
