"""Index build: seconds of the program's build calls at set-up (the
sealed segment from the postings, ``index/sealed.py``; the facade; the
engine's stream index and upload, ``index/stream.py`` and
``search/stream.py``); the benchmark's span around them."""


def read(run):
    return run.build_s
