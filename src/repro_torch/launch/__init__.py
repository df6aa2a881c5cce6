"""Driver CLIs of the port (``python -m repro_torch.launch.<name>``):
``ngram`` runs one n-gram job, ``serve_ngrams`` builds an index and serves
it (micro-batched, streaming, or as the HTTP/SSE frontend), and ``serve``
prefills a batch of prompts through one of the LM archs and decodes them
greedily."""
