"""upload_copy_gbps.pubtrain: the bytes that the program's upload sent
through pinned staging per job, over the mean of its span "upload: copy
to device", read from synthetic Timers; nothing where the program keeps
no such counter or no record of its Timers."""

import pytest

from portbench import harness


def _synthetic_jobs(staged_and_seconds):
    """Timers of jobs whose upload copied `staged` bytes through the
    staging in a copy span of `seconds`, and the jobs' records."""
    from isle_tpu_torch import obs

    timers, jobs = [], []
    for staged, seconds in staged_and_seconds:
        t = obs.Timer()
        t.phases = [("upload A to device", 1.5, 1.0)]
        t.spans = [("upload: copy to device", "upload A to device", 10.0,
                    10.0 + seconds), ("upload: doc ids",
                                      "upload A to device", 20.0, 20.5)]
        if staged is not None:
            t.counters = {"upload staged bytes": staged}
        timers.append(t)
        jobs.append({"phases": {"upload A to device": 1.5}})
    return timers, jobs


@pytest.mark.parametrize("jobs,gbps", [
    ([(4_000_000_000, 0.5)], 8.0),
    ([(3_870_000_000, 0.3), (3_870_000_000, 0.6)], 3.87 / 0.45),
    ([(None, 0.5), (None, 0.4)], None),  # pageable copies: no counter
])
def test_upload_copy_gbps_reads_the_staged_bytes_over_the_copy_span(
        bench, monkeypatch, jobs, gbps):
    from isle_tpu_torch import obs

    timers, recs = _synthetic_jobs(jobs)
    monkeypatch.setattr(obs, "recent_timers", lambda: timers)
    read = harness.metric_reader("upload_copy_gbps.pubtrain")
    got = read({"jobs": recs})
    assert got == (None if gbps is None else pytest.approx(gbps))
    spec = [m for m in bench["per_layer"]
            if m["name"] == "upload_copy_gbps.pubtrain"][0]
    assert (spec["unit"], spec["moves"], spec["workloads"]) == (
        "GB/s", "train_s", ["pubmed-train"])
    monkeypatch.delattr(obs, "recent_timers")
    assert read({"jobs": recs}) is None
