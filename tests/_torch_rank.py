"""One rank of a multi-process `vgan_tpu_torch.cli haplocart` run, with
what a test needs to see of it:

    python tests/_torch_rank.py <final_vec.npy> haplocart --db ... \\
        --coordinator 127.0.0.1:<port> --nproc N --procid I [...]

runs `vgan_tpu_torch.cli.main` on the given arguments, keeping the
final_vec of each sample that `haplocart_runner.run_sample` returns;
host 0 saves the last one to <final_vec.npy>. Every rank then prints
one line `RANK {json}`: its rank, the reads it kept, its kernel
launches (`mapper.sw.LAUNCHES` and `haplocart_device.LAUNCHES`) and its
stage seconds (with --profile).
The JAX package's tests/mh_worker.py plays this part for JAX."""
import json
import os
import sys

import numpy as np
import torch


def main(argv) -> int:
    torch.set_num_threads(1)
    out_path, cli_args = argv[0], argv[1:]
    from vgan_tpu_torch import cli
    from vgan_tpu_torch.mapper import sw
    from vgan_tpu_torch.parallel import multihost
    from vgan_tpu_torch.pipelines import haplocart_device as hd
    from vgan_tpu_torch.pipelines import haplocart_runner as runner
    from vgan_tpu_torch.utils import profiling

    seen = {}
    run_sample = runner.run_sample

    def keeping(*args, **kw):
        pred, n_reads, vec = run_sample(*args, **kw)
        seen.update(rank=multihost.process_id(), n_reads=n_reads, vec=vec)
        return pred, n_reads, vec

    runner.run_sample = keeping
    sw.reset_launches()
    hd.reset_launches()
    rc = cli.main(cli_args)
    if rc != 0:
        return rc
    if seen["rank"] == 0:
        np.save(out_path, seen["vec"])
    stages = {k: s.seconds for k, s in profiling.PROFILER.stages.items()}
    print("RANK " + json.dumps(dict(
        rank=seen["rank"], n_reads=int(seen["n_reads"]),
        launches={**sw.LAUNCHES, **hd.LAUNCHES}, stages_s=stages,
        pid=os.getpid())),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
