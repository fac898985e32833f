"""Algorithmic weak-scaling study of the sharded two-group path on the
virtual CPU mesh (VERDICT round-4 item 7; BASELINE.md scaling target;
the reference's scaling story is its Nextflow fan-out, main.nf:44-70).

Fixed per-device work (one genome block x one seed), devices 1/2/4/8,
halo vs exchange. On a virtual mesh the host's cores are oversubscribed,
so WALL times only bound the trend; the algorithmic claims checked are:

* per-device output shapes and program structure are n-independent,
* the exchange scheme's collective count (collective-permute ops in the
  compiled HLO) is O(1) in the device count — boundary cost does not grow
  with the mesh,
* total wall grows sublinearly in devices (it would be ~flat on real
  devices; on shared cores the bound is ~n/cores).

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     JAX_PLATFORMS=cpu PYTHONPATH=. python tools/weak_scaling.py
"""

import json
import os
import time

import numpy as np

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")


def hlo_collective_counts(jit_fn, *args):
    txt = jit_fn.lower(*args).compile().as_text()
    return {
        "collective_permute": txt.count("collective-permute"),
        "all_reduce": txt.count("all-reduce"),
        "all_gather": txt.count("all-gather"),
    }


def main():
    import jax
    import jax.numpy as jnp

    from hygeia_tpu.parallel import make_mesh, sharded_two_group_inference
    from hygeia_tpu.parallel import sharded as sh

    import __graft_entry__ as ge

    T_B = int(os.environ.get("HYGEIA_WS_TB", 2048))  # sites per device
    M = int(os.environ.get("HYGEIA_WS_M", 8))
    B = int(os.environ.get("HYGEIA_WS_B", 8))
    REPS = int(os.environ.get("REPS", 3))
    SEG, BUF = T_B, max(32, T_B // 16)

    n_max = len(jax.devices())
    results = []
    coll_by_n = {}
    for n in (1, 2, 4, 8):
        if n > n_max:
            break
        T = n * T_B
        params, _, _ = ge._two_group_setup(T)
        rng = np.random.default_rng(n)
        n_tot = rng.poisson(20, size=(T, 2)).astype(np.float32)
        y = np.minimum(rng.poisson(8, size=(T, 2)), n_tot).astype(np.float32)
        mesh = make_mesh(n_genome=n, n_seed=1, devices=jax.devices()[:n])
        for boundary in ("halo", "exchange"):
            kw = dict(
                segment_size=SEG,
                buffer_size=BUF,
                num_resampled_ancestors=M,
                num_samples_backward=B,
                seeds=[0],
                boundary=boundary,
            )
            sharded_two_group_inference(mesh, params, y, n_tot, y, n_tot, **kw)
            walls = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                traj, log_z = sharded_two_group_inference(
                    mesh, params, y, n_tot, y, n_tot, **kw
                )
                walls.append(time.perf_counter() - t0)
            wall = float(np.median(walls))
            results.append(
                {
                    "devices": n,
                    "boundary": boundary,
                    "sites_total": T,
                    "sites_per_device": T_B,
                    "wall_s": round(wall, 3),
                    "device_seconds_per_site": round(wall / T_B * 1e6, 1),
                }
            )
            print(json.dumps(results[-1]), flush=True)

        # HLO collective counts for the exchange program at this n (the
        # halo program has none by construction).
        ex_keys = [k for k in sh._PROGRAMS if k[0] == "exchange" and k[1] is mesh]
        if ex_keys:
            progs = sh._PROGRAMS[ex_keys[-1]]
            # Rebuild representative args matching the last run's shapes.
            blocks = [
                sh.make_block_windows(np.asarray(a, np.float32), SEG, 0, n)
                for a in (y, n_tot, y, n_tot)
            ]
            e_c, e_k = progs["tables"](
                params.alpha, params.beta, *[jnp.asarray(b) for b in blocks]
            )
            keys = jnp.zeros((n, 1, 2), jnp.uint32)
            arrs = tuple(params[2:])
            coll_by_n[n] = hlo_collective_counts(
                progs["run"], arrs, e_c, e_k, keys
            )
            print(json.dumps({"devices": n, "exchange_hlo": coll_by_n[n]}), flush=True)

    # Structural assertions: exchange collective count is O(1) in n.
    counts = [c["collective_permute"] for nn, c in sorted(coll_by_n.items()) if nn > 1]
    if counts:
        assert max(counts) == min(counts), (
            f"exchange collective-permute count grew with devices: {coll_by_n}"
        )
        print(
            f"OK: exchange collective-permute ops constant at {counts[0]} "
            f"across {sorted(n for n in coll_by_n if n > 1)} devices"
        )
    halo = {r["devices"]: r["wall_s"] for r in results if r["boundary"] == "halo"}
    if 8 in halo and 1 in halo:
        ratio = halo[8] / halo[1]
        print(
            f"halo wall 8-dev/1-dev = {ratio:.2f}x for 8x the work "
            f"(host cores oversubscribe the virtual mesh; flat on real chips "
            f"when ratio ~= n/cores here)"
        )


if __name__ == "__main__":
    main()
