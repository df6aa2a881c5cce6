"""Corpora for the n-gram jobs, the LM loader, and the recsys and graph
generators (``recsys``, ``graph``)."""
