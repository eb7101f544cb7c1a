"""The stage-1 training forward and backward, or the stage-2 training step,
of one checkout of the port at 1.3B on the card, so that two checkouts (a
change and its parent) can be held against each other in one call.

    python3 tools/train_step_probe.py DIR REMAT [REMAT ...]
    python3 tools/train_step_probe.py --stage2 DIR REMAT [REMAT ...]

needs one NVIDIA GPU and nvcc. Imports the port from DIR (a checkout, for
example `git archive` of a parent unpacked into a git-ignored directory),
builds the 1.3B model in bf16 with random weights from seed 0, marks the
leaves that stage `align` trains, and times `t2i_loss` and
`torch.autograd.grad` of it at B=90 x 328 (config/config_stage1_t2i.yaml's
batch) under each REMAT (True, False or a policy's name the checkout
accepts): four runs each, the first a warm-up, host clock ending in a
synchronize, TF32 off. Prints the card, then one JSON line: per REMAT the
median forward and backward seconds and each run's sum.

With --stage2 it builds DIR's stage-2 model (`chip_smoke._stage2_model`:
both 384-px towers frozen, the projector, stage `finetune`) and times four
optimizer steps (`make_train_step`) on one mixed batch of 48 t2i rows of
329 and 3 mmu rows of 1,182 (`chip_smoke._mixed_batch`, seed 0), the t2i
flow under TrainConfig.remat=REMAT ("proj": DIR's own rule), the mmu flow
every block checkpointed; each step ends in the loss read and a
synchronize.

Run the parent and the change in turns in one call (parent, change, change,
parent): two calls may land on two cards.
"""

import json
import statistics
import subprocess
import sys
import time


def stage2(choices):
    import numpy as np
    import torch

    import chip_smoke as cs
    from omnimamba_tpu_torch.train.trainer import create_train_state, make_train_step

    out = {}
    for choice in choices:
        tcfg, model, params, _ = cs._stage2_model()
        tcfg.remat = {"True": True, "False": False}.get(choice, choice)
        batch = cs._mixed_batch(np.random.default_rng(0), model.cfg, cs.STAGE2_T2I_BATCH,
                                cs.STAGE2_MMU_BATCH)
        state, tx = create_train_state(params, tcfg)
        step = make_train_step(model, tx, tcfg, dtype=torch.bfloat16, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        seconds = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.time()
            state, metrics = step(state, batch, gen)
            float(metrics["loss"])
            torch.cuda.synchronize()
            seconds.append(time.time() - t0)
        out[choice] = {"step_s": seconds, "median_after_first": statistics.median(seconds[1:]),
                       "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
        del state, tx, step, params, model
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return out


def main(argv):
    two = argv[0] == "--stage2"
    root, choices = argv[int(two)], argv[int(two) + 1:]
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from omnimamba_tpu_torch import MambaConfig, OmniMambaModel, VQConfig, init_omnimamba
    from omnimamba_tpu_torch.config import TrainConfig
    from omnimamba_tpu_torch.models.omnimamba import t2i_loss
    from omnimamba_tpu_torch.train.optimizer import named_leaves
    from omnimamba_tpu_torch.train.trainer import create_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    if two:
        print(json.dumps({"root": root, "card": torch.cuda.get_device_name(0), "stage2": True,
                          **stage2(choices)}), flush=True)
        return
    cfg = MambaConfig()
    model = OmniMambaModel(cfg=cfg, vq_cfg=VQConfig(), sptids={})
    params = init_omnimamba(torch.Generator(device="cuda").manual_seed(0), model, torch.bfloat16,
                            "cuda", with_vq=False)
    create_train_state(params, TrainConfig(stage="align", t2i_task=True, mmu_task=False,
                                           batch_size_t2i=90))
    leaves = [t for _, t in named_leaves(params) if t.requires_grad]
    rng = np.random.default_rng(0)
    img = torch.as_tensor(rng.integers(0, cfg.vqvae_vocab_size, (90, 256)), device="cuda")
    cap = torch.as_tensor(rng.integers(0, cfg.vocab_size, (90, 72)), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {"root": root, "card": torch.cuda.get_device_name(0)}
    for choice in choices:
        remat = {"True": True, "False": False}.get(choice, choice)
        fwd, bwd = [], []
        for i in range(4):
            torch.cuda.synchronize()
            t0 = time.time()
            loss = t2i_loss(params, model, img, cap, dtype=torch.bfloat16, generator=gen,
                            remat=remat)
            torch.cuda.synchronize()
            t1 = time.time()
            torch.autograd.grad(loss, leaves, allow_unused=True)
            torch.cuda.synchronize()
            if i:
                fwd.append(t1 - t0)
                bwd.append(time.time() - t1)
        out[choice] = {"forward_s": statistics.median(fwd), "backward_s": statistics.median(bwd),
                       "fwd_bwd_s": [a + b for a, b in zip(fwd, bwd)]}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
