"""Multi-tenant LoRA fine-tuning on the PyTorch port: hundreds of per-user
adapters share every batch, and each tenant gets independent DP guarantees
— all from ONE fused pass per step. The twin of
``examples/lora_multitenant.py``.

Each tenant owns a LoRA adapter (frozen shared base + low-rank delta). A
step takes an interleaved mixed-tenant batch; the service sorts it by
tenant, gathers the active adapter rows, computes exact per-example
gradient norms through the segmented tap (one launch per factor across
ALL tenants), clips per example, draws each tenant's DP noise from a
generator derived from the step's seed and its id — so tenant t's update
is the one it would get if it trained alone — and scatters the updated
rows back. Admission and eviction recycle store slots between steps.

    PYTHONPATH=src python examples/torch_lora_multitenant.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.nn import lora
from repro_torch.nn.linear import linear
from repro_torch.tenancy import AdapterStore, TenantService

D_IN, D_OUT, RANK, SEQ = 32, 16, 4, 12
CLIP, SIGMA, LR = 1.0, 0.2, 0.05


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    base_w = 0.2 * torch.randn(D_IN, D_OUT, generator=gen, device=dev)

    # one LoRA site per tenant; B starts random so step-0 grads are live
    def init_fn(g):
        return {"proj": lora.init_pair(g, D_IN, D_OUT, RANK, 8.0,
                                       device=g.device, b_std=0.3)}

    # user loss: per-example adapters ride a leading (B,) axis; the
    # factors route through tap.dense_batched inside nn.linear
    def loss_fn(adapters, data, tap):
        p = {"w": base_w, "lora": adapters["proj"]}
        z = linear(p, data["x"], tap=tap, group="all")
        tok = torch.sum(torch.square(z - data["y"]), dim=-1)
        return torch.sum(tap.token_loss(tok), dim=1), {}

    store = AdapterStore(init_fn, capacity=512, seed=1, device=dev)
    svc = TenantService(store, loss_fn, clip_norm=CLIP, noise_std=SIGMA,
                        lr=LR)

    rs = np.random.RandomState(0)
    tenants = rs.choice(20_000, size=300, replace=False)
    for step in range(5):
        # interleaved mixed batch: ~120 tenants, ragged 1-4 examples each
        active = rs.choice(tenants, size=120, replace=False)
        owner = np.concatenate(
            [np.full(rs.randint(1, 5), t) for t in active])
        rs.shuffle(owner)
        b = len(owner)
        x = torch.randn(b, SEQ, D_IN, generator=gen, device=dev)
        y = torch.randn(b, SEQ, D_OUT, generator=gen, device=dev)
        res = svc.step({"x": x, "y": y}, owner,
                       rng=torch.Generator(device=dev).manual_seed(
                           1000 + step))
        clipped = (res.clip_coef < 1.0).float().mean().item() * 100
        print(f"step {step}: B={b:3d} tenants={len(res.tenant_ids):3d} "
              f"resident={store.n_active:3d} loss={res.loss.item():9.1f} "
              f"clipped={clipped:4.0f}% "
              f"worst tenant loss={res.tenant_loss.max().item():7.1f}")

        if step == 2:
            # mid-run churn: retire the coldest third, queue newcomers
            for t in [int(t) for t in store.tenants[:100]]:
                svc.evict(t)
            svc.submit(*rs.choice(50_000, size=40, replace=False).tolist())
            admitted = svc.admit_pending()
            print(f"         evicted 100 tenants, admitted "
                  f"{len(admitted)} from the queue")

    # the per-tenant DP contract: tenant t's noised update depended only on
    # its own examples, the step's seed and its id — batchmates never leak
    # in (tests/test_torch_tenancy.py holds it against single-tenant
    # engines and the reference's service)
    t = int(owner[0])
    n_t = int(np.sum(owner == t))
    row = store.gather(np.array([t]))
    print(f"\ntenant {t}: {n_t} examples in the last mixed batch; "
          f"adapter row head {row['proj'].a.reshape(-1)[:3].tolist()}")


if __name__ == "__main__":
    main()
