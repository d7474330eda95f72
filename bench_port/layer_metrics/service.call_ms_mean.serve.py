"""Mean host milliseconds of a call into ``RecommendationService.
recommend_batch``, from the benchmark's ``bench.service`` spans."""


def read(res, ctx):
    tr = res.get("trace")
    calls = tr.span_host_s.get("service") if tr is not None else None
    return 1e3 * sum(calls) / len(calls) if calls else None
