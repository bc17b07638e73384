"""Phase (n) of ``chip_smoke.py`` alone on the card: serving across ranks
on a one-rank NCCL group and the (1, 1) (data, model) mesh.

    python3 tools/serve_mesh_probe.py

Run from the root of a checkout on a machine with one NVIDIA GPU.  It
starts the group, builds the mesh and calls
``chip_smoke.serving_across_ranks`` with phase (h)-(j)'s inputs of an arch
(the same seeds), so FULL whisper-medium (``decode``) and FULL
Mamba2-2.7B (``long``, batch 1) run unsharded, sharded and sharded again,
held bitwise to each other with their launch counts.  No earlier phase
runs, so the first (unsharded) prefill of each arch holds its kernels'
nvcc build: read its decode and sharded times, not its prefill.
"""
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, os.path.join(HERE, ".."))


def main():
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    from repro_torch.launch.mesh import make_mesh_shape

    if not torch.cuda.is_available():
        sys.exit("serve_mesh_probe: torch.cuda.is_available() is False: "
                 "this probe needs a GPU")
    w0 = time.perf_counter()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    counters = (fa.LAUNCHES, ssd.LAUNCHES)

    def reset():
        for c in counters:
            for k in c:
                c[k] = 0

    def read_counts():
        return {k: v for c in counters for k, v in c.items()}

    def expect(counts, **want):
        full = {k: 0 for k in read_counts()}
        full.update(want)
        return counts == full

    def serving_batch(fcfg, S_):  # chip_smoke.py's, for these families
        prompt_ = torch.as_tensor(np.random.default_rng(cs.SEED).integers(
            0, fcfg.vocab, (cs.SERVE_B, S_)), device=dev)
        batch_ = {"tokens": prompt_}
        g = torch.Generator(dev).manual_seed(cs.SEED + 1)
        if fcfg.family == "encdec":
            batch_["enc_embeds"] = torch.randn(
                (cs.SERVE_B, fcfg.enc_len, fcfg.d_model), generator=g,
                device=dev)
        return batch_, S_, None

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh_shape((1, 1), ("data", "model"))
        print("mesh", mesh, "setup", time.perf_counter() - w0, flush=True)
        t = time.perf_counter()
        cs.serving_across_ranks(mesh, dev, card, serving_batch, reset,
                                read_counts, expect)
        print("phase (n) total", time.perf_counter() - t, "s", flush=True)
    finally:
        dist.destroy_process_group()
    print("PROBE OK")


if __name__ == "__main__":
    main()
