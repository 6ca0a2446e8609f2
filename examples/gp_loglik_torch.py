"""GP marginal log-likelihood through the port's secure-linalg family.

The intended workload shape for `repro_torch.linalg` (DESIGN.md §12): a
Gaussian-process hyperparameter step needs log|Σ| AND solves against Σ
inside one differentiated objective —

    -2·logp(y) = log|Σ(θ)| + yᵀ Σ(θ)⁻¹ y + n·log(2π)

Both terms route through `secure_slogdet` / `secure_solve`: ONE verified
outsourced factorization of Σ per objective evaluation serves the value
and the whole backward pass (∂log|Σ|/∂Σ = Σ⁻ᵀ and the solve adjoint are
triangular-solve rounds through the SAME factors), so the untrusted
fleet does the O(n³) work and the client keeps O(n²).

    python examples/gp_loglik_torch.py [--n 128] [--servers 2]
        [--transport inline] [--gateway] [--device cpu]

The twin of examples/gp_loglik.py (torch autograd where it has jax.grad;
the reference objective is torch.linalg's): the same flags and printed
checks, plus --device (default: the CUDA device). --gateway additionally
serves the same (slogdet, solve) pair through the SPDC gateway's
op-keyed buckets.
"""
import argparse
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.linalg import SecureLinalg, secure_slogdet, secure_solve


def rbf_cov(x, log_ell, log_sf, log_noise):
    """RBF kernel matrix Σ(θ) on 1-d inputs — differentiable in θ."""
    d2 = (x[:, None] - x[None, :]) ** 2
    k = torch.exp(2.0 * log_sf) * torch.exp(-0.5 * d2 / torch.exp(2.0 * log_ell))
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    return k + torch.exp(2.0 * log_noise) * eye


def make_objectives(x, y, linalg_ctx):
    """(secure, reference) negative log-marginal-likelihood closures."""
    n = x.shape[0]

    def nll_secure(theta):
        cov = rbf_cov(x, *theta)
        _, logdet = secure_slogdet(cov, linalg=linalg_ctx)
        alpha = secure_solve(cov, y, linalg=linalg_ctx)
        return 0.5 * (logdet + y @ alpha + n * math.log(2.0 * math.pi))

    def nll_reference(theta):
        cov = rbf_cov(x, *theta)
        _, logdet = torch.linalg.slogdet(cov)
        alpha = torch.linalg.solve(cov, y)
        return 0.5 * (logdet + y @ alpha + n * math.log(2.0 * math.pi))

    return nll_secure, nll_reference


def value_and_grad(fn, theta):
    """fn(θ) and its gradient by torch autograd."""
    theta = theta.detach().clone().requires_grad_(True)
    value = fn(theta)
    (grad,) = torch.autograd.grad(value, theta)
    return value.detach(), grad


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128, help="training points")
    ap.add_argument("--servers", type=int, default=2)
    ap.add_argument("--transport",
                    choices=["inline", "threadpool", "multiprocess",
                             "socket"],
                    default="inline")
    ap.add_argument("--steps", type=int, default=3,
                    help="gradient-descent steps to take")
    ap.add_argument("--gateway", action="store_true",
                    help="also serve the (slogdet, solve) pair through "
                         "the SPDC gateway's op-keyed buckets")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()

    from repro_torch.api.transport import resolve_transport
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    x_np = np.sort(rng.uniform(-3.0, 3.0, args.n))
    y_clean = np.sin(2.0 * x_np) + 0.5 * x_np
    x = torch.from_numpy(x_np).to(dev)
    y = torch.from_numpy(y_clean + 0.1 * rng.standard_normal(args.n)).to(dev)

    transport = resolve_transport(args.transport, device=dev)
    ctx = SecureLinalg(args.servers, transport=transport, device=dev)
    nll_secure, nll_ref = make_objectives(x, y, ctx)

    theta = torch.tensor([np.log(0.8), np.log(1.0), np.log(0.2)],
                         dtype=torch.float64, device=dev)

    print(f"GP log-likelihood, n={args.n}, N={args.servers} "
          f"({args.transport} transport)")
    for step in range(args.steps):
        ctx.clear()  # new θ ⇒ new Σ ⇒ new session next evaluation
        val, grad = value_and_grad(nll_secure, theta)
        ref_val, ref_grad = value_and_grad(nll_ref, theta)
        gerr = float((grad - ref_grad).abs().max()
                     / (ref_grad.abs().max() + 1e-30))
        sessions = list(ctx._sessions.values())
        facts = sum(s.factorizations for s in sessions)
        print(f"  step {step}: nll={float(val):.6f} "
              f"(ref {float(ref_val):.6f}) |grad err|={gerr:.2e} "
              f"factorizations={facts} (sessions={len(sessions)})")
        assert np.isclose(float(val), float(ref_val), rtol=1e-9), \
            "secure nll diverged from the torch.linalg reference"
        assert gerr < 1e-6, f"gradient error {gerr:.2e} exceeds 1e-6"
        assert facts == len(sessions) == 1, \
            "a gradient step must share ONE factorization"
        # normalized step: raw NLL gradients overshoot in log-space
        theta = theta - 0.1 * grad / (torch.linalg.norm(grad) + 1.0)
    print("OK: value and gradient match the plaintext reference; each "
          "step used one shared verified LU.")

    if args.gateway:
        from repro_torch.configs.spdc import SPDC_GATEWAY_DEFAULT
        from repro_torch.serve.spdc_gateway import SPDCGateway

        with torch.no_grad():
            cov = rbf_cov(x, *theta).cpu().numpy()
        y_np = y.cpu().numpy()
        # kernel matrices need the growth-safe relayout (the reason it is
        # the LinalgSession default): no-pivot LU growth on a near-SPD Σ
        # overflows the verifier otherwise. It is a bucket dimension, so
        # the override rides the submit call.
        with SPDCGateway(SPDC_GATEWAY_DEFAULT, device=dev) as gw:
            r_sl = gw.submit(cov, op="slogdet", growth_safe=True)
            r_sv = gw.submit(cov, op="solve", rhs=y_np, growth_safe=True)
            gw.drain()
            sl, sv = gw.take(r_sl), gw.take(r_sv)
        ws, wl = np.linalg.slogdet(cov)
        alpha = np.linalg.solve(cov, y_np)
        assert sl.verified and sl.sign == ws and \
            np.isclose(sl.logabs, wl, rtol=1e-9)
        solution = np.asarray(torch.as_tensor(sv.solution).cpu())
        serr = float(np.linalg.norm(solution - alpha) / np.linalg.norm(alpha))
        assert sv.verified and serr < 1e-8, serr
        print(f"OK: gateway op-keyed buckets agree "
              f"(slogdet bucket + solve bucket, solve err {serr:.2e}).")


if __name__ == "__main__":
    main()
