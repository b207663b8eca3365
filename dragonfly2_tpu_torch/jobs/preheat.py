"""Preheat: warm content into seed peers ahead of demand.

Reference flow (SURVEY §3.5): console → manager resolves image layers /
file URLs → machinery group job fanned to scheduler clusters
(manager/job/preheat.go:126-167) → each scheduler's job worker triggers a
seed-peer download (scheduler/job/job.go:203-283 → seed_peer.go
TriggerDownloadTask).

Here: ``preheat()`` creates the group job over the target schedulers'
queues; each scheduler's worker handler drives a seed daemon's conductor
to fetch the URL, so subsequent peers find a warm parent.

Port of ``dragonfly2_tpu/jobs/preheat.py``, verbatim but for the imports.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

from ..utils.types import Priority
from .queue import GroupJob, JobQueue

PREHEAT = "preheat"

# Preheat is warm-ahead-of-demand BACKGROUND work (DESIGN.md §26): the
# fan-out runs at the lowest priority class, so the seeder queue orders
# it behind interactive pulls and overload admission sheds it FIRST.
PREHEAT_PRIORITY = Priority.LEVEL6


@dataclass
class PreheatJob:
    group: GroupJob
    urls: List[str]


def preheat(
    broker: JobQueue,
    urls: Sequence[str],
    scheduler_queues: Sequence[str],
    *,
    piece_size: int = 4 << 20,
) -> PreheatJob:
    """Fan a preheat of the URLs out to every target scheduler's queue."""
    from ..utils.tracing import default_tracer

    with default_tracer.span(
        "jobs/preheat", urls=len(urls), queues=len(scheduler_queues)
    ) as span:
        per_queue = {
            q: {
                "urls": list(urls),
                "piece_size": piece_size,
                "priority": int(PREHEAT_PRIORITY),
            }
            for q in scheduler_queues
        }
        group = broker.create_group_job(PREHEAT, per_queue)
        span.set(group_id=group.id)
        return PreheatJob(group=group, urls=list(urls))


def preheat_image(
    broker: JobQueue,
    manifest_url: str,
    scheduler_queues: Sequence[str],
    resolver,
    *,
    piece_size: int = 4 << 20,
) -> PreheatJob:
    """Resolve an image's layer blobs and fan them out (the console's
    type=image preheat: manager/job/preheat.go:90-167)."""
    from ..utils.tracing import default_tracer

    with default_tracer.span(
        "jobs/preheat", image=manifest_url, queues=len(scheduler_queues)
    ) as span:
        resolved = resolver.resolve_layers(manifest_url)
        per_queue = {
            q: {
                "urls": list(resolved.urls),
                "piece_size": piece_size,
                "headers": dict(resolved.headers),
                "priority": int(PREHEAT_PRIORITY),
            }
            for q in scheduler_queues
        }
        group = broker.create_group_job(PREHEAT, per_queue)
        span.set(group_id=group.id, urls=len(resolved.urls))
        return PreheatJob(group=group, urls=list(resolved.urls))


def make_preheat_handler(seed_daemon, *, content_length_for=None):
    """Handler for a scheduler's worker: seed daemon downloads each URL.

    ``content_length_for(url)`` supplies origin sizes (HEAD request in a
    wire deployment); defaults to one piece.
    """

    def handler(args: Dict) -> Dict:
        from ..utils.tracing import default_tracer

        # The worker-side half of the fan-out: one span per executed
        # preheat job, so the manager's jobs/preheat span and each
        # scheduler's execution land in the same flight-recorder story.
        with default_tracer.span(
            "jobs/preheat.execute", urls=len(args["urls"])
        ):
            return _execute(args)

    def _execute(args: Dict) -> Dict:
        from ..source.client import call_with_optional_headers

        headers = args.get("headers") or None
        results = {}
        for url in args["urls"]:
            if content_length_for is not None:
                cl = call_with_optional_headers(
                    content_length_for, url, headers=headers
                )
            else:
                cl = args["piece_size"]
            # The registry pull token rides to the origin fetcher —
            # private-registry blobs need it on every GET.  Preheat runs
            # at the background class: the job args carry LEVEL6 so the
            # seed's download (and its scheduler registration) yields to
            # interactive pulls end-to-end (DESIGN.md §26).
            r = seed_daemon.download(
                url, piece_size=args["piece_size"], content_length=cl,
                source_headers=headers,
                priority=Priority(int(args.get("priority", PREHEAT_PRIORITY))),
            )
            if not r.ok:
                raise RuntimeError(f"preheat of {url} failed")
            results[url] = r.pieces
        return results

    return handler
