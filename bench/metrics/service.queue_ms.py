"""service.queue_ms: mean wait in the service's admission queue, ms.

Each execution's ``QueryOutcome.queued_s`` (the ``queue`` lane: from
``submit`` to a worker taking the query), averaged over every execution
of the window: a PHJ cell's queries, a pipeline's stages and sink."""
from bench.records import Readings


def read(r: Readings):
    waits = [s.queued_s for q in r.queries for s in q.stages]
    return 1e3 * sum(waits) / len(waits) if waits else None
