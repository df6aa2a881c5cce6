"""Corpora for the n-gram jobs."""
