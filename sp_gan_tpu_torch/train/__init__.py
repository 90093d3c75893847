"""Checkpoint reading (training comes in a later slice)."""
