"""One rank of the sharded cell with the program broken underneath, for
test_portbench_faults.py: ``python fault_rank.py FAULT <run.py args>``."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def break_program(fault):
    from pcseg_tpu_torch.parallel import halo, sharded
    if fault == "no_exchange":
        # every rank's block in every slot: the gather between chips left out
        def all_gather(self, x):
            return x[None].expand(self.size, *x.shape).contiguous()
        halo.Comm.all_gather = all_gather
    elif fault == "altered_answer":
        real = sharded.build_sharded_segment_step

        def build(*a, **kw):
            step = real(*a, **kw)

            def altered(*sa, **skw):
                res = step(*sa, **skw)
                labels = res.labels.clone()
                labels[0, 0] += 1
                return res._replace(labels=labels)
            return altered
        sharded.build_sharded_segment_step = build
    elif fault != "none":
        raise SystemExit(f"unknown fault {fault}")


if __name__ == "__main__":
    break_program(sys.argv[1])
    from portbench.bench import ranks
    from portbench.run import parse
    ranks.rank_main(parse(sys.argv[2:]))
