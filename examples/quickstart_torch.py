"""Quickstart — the MFS scheduler in 60 lines.

Builds the paper's Table-1 scenario by hand, runs it under four
stage-agnostic baselines and under MFS, and prints who met their deadline.
No model weights involved: the scheduler is pure control plane.

The PyTorch port's ``examples/quickstart.py``: the same run through
``repro_torch``'s control plane, with the same arguments and output.
It holds no tensors, so it has no device to pick.

    PYTHONPATH=src python examples/quickstart_torch.py
"""
from repro_torch.core import MFSScheduler, Stage, make_policy
from repro_torch.netsim.toy import make_flow, run_toy

# Three requests contending for one bottleneck link (paper Table 1):
#   name: (flow size, downstream remain-time, request TTFT deadline)
REQUESTS = {"A": (2.0, 9.0, 18.0), "B": (4.0, 6.0, 12.0), "C": (3.0, 0.0, 7.0)}


def run(policy_name: str) -> None:
    flows = {}
    for rid, (name, (size, remain, dr)) in enumerate(REQUESTS.items()):
        # MFS sees the *materialised* flow deadline (D_r - downstream remain)
        # - the paper's key observation; stage-agnostic baselines only have
        # the request-level deadline.
        deadline = dr - remain if policy_name == "mfs" else dr
        flows[name] = make_flow(Stage.P2D, size=size, deadline=deadline,
                                rid=rid)
    policy = (MFSScheduler() if policy_name == "mfs"
              else make_policy(policy_name))
    finish = run_toy(list(flows.values()), policy)

    print(f"\n--- {policy_name.upper()} ---")
    for name, f in flows.items():
        size, remain, dr = REQUESTS[name]
        done = finish[f.fid] + remain          # flow done + downstream work
        verdict = "MET " if done <= dr + 1e-6 else "MISS"
        print(f"  req {name}: flow finished t={finish[f.fid]:5.2f}  "
              f"request done t={done:5.2f}  deadline {dr:5.1f}  [{verdict}]")


if __name__ == "__main__":
    for pol in ("fs", "sjf", "edf", "karuna", "mfs"):
        run(pol)
    print("\nMFS (Defer-and-Promote over the RMLQ) is the only policy that"
          "\nmeets all three deadlines - compare with Table 1/2 of the paper.")
