"""The plain reference that decides ``correct``: BM25 top-k in plain
PyTorch over the benchmark's own postings.  It imports nothing of the port
and takes nothing the port made."""
