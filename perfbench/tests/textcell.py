"""A tiny full-text configuration and mix for the CPU tests: the FTSB
shape (a title of weight 2 and a body, over one zipf vocabulary) with a
TAG field, queried by the eight families of the port's own bench
(`bench/workloads.py` `FAMILIES`) through term slots."""

CONFIG = {
    "name": "tiny-text", "index": "docs", "n_docs": 2000,
    "key_format": "d%d",
    "fields": [
        {"name": "title", "type": "TEXT", "weight": 2, "draw": "zipf_words",
         "vocab": 3000, "format": "w%06d", "a": 1.25, "tokens": 4},
        {"name": "body", "type": "TEXT", "draw": "zipf_words",
         "vocab": 3000, "format": "w%06d", "a": 1.25,
         "tokens": {"min": 8, "max": 40, "median": 16, "sigma": 0.5}},
        {"name": "cat", "type": "TAG", "draw": "zipf", "n_values": 16,
         "a": 0.0, "format": "cat%02d"}],
}

FAMILIES = {"and2": "<t> <t>", "phrase": '"<p> <p>"',
            "and2_tag": "<t> <t> @cat:{<c>}", "and3": "<t> <t> <t>",
            "or2": "<t>|<t>", "not2": "<t> -<t>", "opt2": "<t> ~<t>",
            "fields2": "@title:<a> @body:<b>"}

MIX = {
    "entry": "search", "batch": 16, "k": 10, "warmup_batches": 1,
    "check": 48,
    "families": [{"name": n, "query": q} for n, q in FAMILIES.items()],
    "slots": {"t": {"draw": "term", "field": "body", "lo": 2, "hi": 60},
              "p": {"draw": "term", "field": "body", "lo": 0, "hi": 30,
                    "by": "share"},
              "a": {"draw": "term", "field": "title", "lo": 0, "hi": 40},
              "b": {"draw": "term", "field": "body", "lo": 0, "hi": 40},
              "c": {"draw": "tag", "field": "cat"}},
}
