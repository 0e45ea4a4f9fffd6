"""The port's serving path against ``repro.launch.serve`` and
``repro.fault.PreemptionSource``, on the CPU at smoke size.

``serve_batch`` runs in float32 compute on both sides with JAX's weights
carried across, so the greedy tokens are equal.  ``PreemptionSource``
draws its lifetimes from the same ``np.random.default_rng(seed)`` uniforms
on both sides and inverts them in float64 (JAX under x64), so lifetimes
agree to rtol 1e-10 and every reuse decision over a grid of ages and job
lengths is the same.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as JC
from repro.core import distributions as JD
from repro.fault import PreemptionSource as JSource
from repro.launch import serve as JS
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.core import carry
from repro_torch.fault import PreemptionSource as TSource
from repro_torch.launch import serve as TS
from repro_torch.models import weights as TW


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "llama3.2-1b"])
def test_serve_batch_matches_jax(arch):
    cfg = dataclasses.replace(JC.smoke(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(TC.smoke(arch), compute_dtype="float32")
    params, _ = JT.init(cfg, jax.random.PRNGKey(0))
    model = TW.from_jax_params(
        tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    # 32 prompt tokens + 12 decoded cross the recurrentgemma smoke window
    # (16) into the ring buffer
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (3, 32))
    want = JS.serve_batch(cfg, params, jnp.asarray(prompts, jnp.int32),
                          n_decode=12)
    got = TS.serve_batch(tcfg, model, prompts, n_decode=12, device="cpu")
    assert got.shape == (3, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _sources(dist_j, family, n_pods, seed):
    fields = {f.name: np.asarray(getattr(dist_j, f.name))
              for f in dataclasses.fields(dist_j)}
    dist_t = carry.dist_from_numpy(family, fields, device="cpu")
    return (JSource(dist_j, n_pods=n_pods, seed=seed),
            TSource(dist_t, n_pods=n_pods, seed=seed, device="cpu"))


@pytest.mark.parametrize("family,dist", [
    ("constrained", JD.constrained_for()),
    ("constrained", JD.constrained_for("n1-highcpu-32")),
    ("diurnal_constrained", JD.diurnal_for("n1-highcpu-16", 20.0)),
])
def test_preemption_source_matches_jax(family, dist):
    with jax.enable_x64(True):
        js, ts = _sources(dist, family, n_pods=6, seed=3)
        np.testing.assert_allclose(ts.lifetimes, js.lifetimes, rtol=1e-10)
        # on JAX 0.9 repro's lifetimes come back as a read-only numpy view,
        # so its replace_pod cannot assign into them without this copy
        js.lifetimes = js.lifetimes.copy()
        for pod, now in ((0, 1.5), (4, 7.25)):
            js.replace_pod(pod, now)
            ts.replace_pod(pod, now)
        np.testing.assert_allclose(ts.lifetimes, js.lifetimes, rtol=1e-10)
        np.testing.assert_array_equal(ts.launch_age, js.launch_age)
        for now in (0.2, 3.0, 23.9):
            assert [e.pod_id for e in ts.poll(now)] == \
                [e.pod_id for e in js.poll(now)]
        js2, ts2 = _sources(dist, family, n_pods=1, seed=11)
        decisions = []
        for job_hours in (0.05, 0.5, 2.0, 6.0):
            for age in np.linspace(0.0, 23.9, 60):
                want = js2.reuse_decision(0, job_hours, age)
                assert ts2.reuse_decision(0, job_hours, age) == want, \
                    (job_hours, age)
                decisions.append(want)
    assert any(decisions) and not all(decisions)


def test_serve_cli_runs_on_the_cpu(capsys):
    TS.main(["--arch", "recurrentgemma-2b", "--smoke", "--device", "cpu",
             "--batches", "2", "--batch-size", "2", "--prompt-len", "16",
             "--decode", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("batch 0: (2, 4) tokens")
    assert out[-1].startswith("served 2 batches")
