"""``repro_torch.examples.bubbletea_serve`` against the reference's
``examples/bubbletea_serve.py``: the Atlas simulation's and BubbleTea's lines
are the reference's exactly, apart from the placement search's host
microseconds; the Splitwise part, served on the CPU from the reference's
``PRNGKey(0)`` smoke GPT-A converted, gives the reference's tokens for every
request and moves the same KV bytes."""
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.transformer import build_model as ref_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.examples import bubbletea_serve
from torch_example_helpers import converted, reference_example

TIMED = "placement search"
SIMULATED = ("[atlas]", "[bubbletea]")


def test_bubbletea_serve_prints_the_reference_s_lines_and_tokens(monkeypatch, capsys):
    ref = reference_example("bubbletea_serve")
    served = []

    class Recorded(ref.SplitwiseCluster):
        def serve(self, requests):
            served.append((self, super().serve(requests)))
            return served[-1][1]

    monkeypatch.setattr(ref, "SplitwiseCluster", Recorded)
    _, params = converted(ref_build_model(ref_smoke_config("gpt_a")), get_smoke_config("gpt_a"))
    ref.main()
    want = capsys.readouterr().out.splitlines()
    got = bubbletea_serve.main(device="cpu", params=params)
    lines = capsys.readouterr().out.splitlines()

    sim = [ln for ln in want if ln.startswith(SIMULATED) and TIMED not in ln]
    assert len(sim) == 5 and [ln for ln in lines if ln.startswith(SIMULATED) and TIMED not in ln] == sim
    assert sum(TIMED in ln for ln in lines) == 1
    assert [ln for ln in lines if ln.startswith("[splitwise]")] == [ln for ln in want if ln.startswith("[splitwise]")]
    ((cluster, done),) = served
    assert got["kv_bytes_moved"] == cluster.kv_bytes_moved > 0
    assert [(r.req_id, r.generated) for r in got["requests"]] == [(r.req_id, r.generated) for r in done]
