"""cache_hit_share.stream: the share of query rows the query cache answered
over the window, the ``hits`` over the ``rows`` of the program's consulting
``svc.cache`` spans, in percent."""
LAYER = "service (serve/service.StreamingNGramService)"
UNIT = "%"
MOVES = "stream_terms_per_s"
SOURCE = "program_counter"


def value(record):
    consults = [e["args"] for e in record.get("spans") or []
                if e["name"] == "svc.cache" and "rows" in (e.get("args") or {})]
    rows = sum(a["rows"] for a in consults)
    return 100 * sum(a["hits"] for a in consults) / rows if rows else None
