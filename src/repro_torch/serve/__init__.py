"""Continuous-batching server over the resumable slot API."""
