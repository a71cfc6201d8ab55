"""The comparison that decides a run's ``correct``.

Once the window has closed and the program's state is freed, a sample of
the requests finished inside the window, drawn from the run's seed with
the longest among them, is run through the plain reference (the family's
``served_model`` at its ``REFERENCE`` precision, a module of
``reference/``) over each prompt with the tokens the engine served, in
full f32 (``reference.full_f32``). The numbers compared:

* ``token_gap``: the widest gap, over every served token, by which the
  served token's reference logit lies below the reference's best logit
  at that position (0 where the served token is the reference's argmax).
  Greedy serving makes it the width of the program's numerical noise
  near the top of the distribution.
* ``prompt_logprob_err`` (mixes that score the prompt): the widest
  absolute gap between a served prompt logprob and the reference's
  log-softmax at that position.

The control puts the reference in the program's place at one precision
lower (the family's ``CONTROL``) and is read the same way: its argmax at
each position, judged by the reference's logits, and its prompt logprobs.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmarks.weights import seed64


def sample(finished: List, seed: int, want_values: int,
           min_requests: int, prompt_logprobs: bool) -> List:
    """Requests to compare: the one with the most served values (tokens,
    and prompt logprobs when scored), then others in an order drawn from
    the seed, until ``want_values`` values and ``min_requests`` requests
    are reached."""
    if not finished:
        return []

    def values(r):
        return len(r.generated) + (len(r.prompt) - 1 if prompt_logprobs
                                   else 0)

    longest = max(range(len(finished)),
                  key=lambda i: (values(finished[i]), len(finished[i].prompt),
                                 -i))
    rng = np.random.default_rng(seed64(seed))
    order = [longest] + [i for i in rng.permutation(len(finished)).tolist()
                         if i != longest]
    out, total = [], 0
    for i in order:
        if total >= want_values and len(out) >= min_requests:
            break
        out.append(finished[i])
        total += values(finished[i])
    return out


def _gap(ref: torch.Tensor, picks: torch.Tensor) -> float:
    """Widest (best reference logit - reference logit of the pick)."""
    best = ref.max(dim=-1).values
    got = ref.gather(1, picks[:, None])[:, 0]
    return float((best - got).max())


def _prompt_lp(rows: torch.Tensor, prompt) -> torch.Tensor:
    """log-softmax at each prompt position t < n - 1 of token t + 1."""
    nxt = torch.as_tensor(list(prompt[1:]), dtype=torch.long,
                          device=rows.device)
    lp = torch.log_softmax(rows[:-1].double(), dim=-1)
    return lp.gather(1, nxt[:, None])[:, 0]


def compare(reference, reqs: List, prompt_logprobs: bool,
            control=None) -> Dict:
    """Readings of the served requests ``reqs`` against the served model
    ``reference``: {"program": {number: value}} and, with a ``control``
    (the served model one precision lower), {"control": {number: value}}
    too. Run it under ``reference.full_f32``."""
    names = ["program"] + (["control"] if control is not None else [])
    out: Dict[str, Dict[str, float]] = {k: {"token_gap": 0.0} for k in names}
    if prompt_logprobs:
        for k in out:
            out[k]["prompt_logprob_err"] = 0.0
    for r in reqs:
        served, prows = reference.logits(r.prompt, r.generated,
                                         prompt_logprobs)
        picks = torch.as_tensor(r.generated, dtype=torch.long,
                                device=served.device)
        rd = out["program"]
        rd["token_gap"] = max(rd["token_gap"], _gap(served, picks))
        ref_lp = _prompt_lp(prows, r.prompt) if prompt_logprobs else None
        if prompt_logprobs:
            got = torch.as_tensor(r.prompt_logprob_values,
                                  dtype=torch.float64, device=served.device)
            rd["prompt_logprob_err"] = max(rd["prompt_logprob_err"], float(
                (got - ref_lp).abs().max()))
        if control is not None:
            c_served, c_rows = control.logits(
                r.prompt, r.generated, prompt_logprobs)
            cd = out["control"]
            cd["token_gap"] = max(cd["token_gap"], _gap(
                served, c_served.argmax(dim=-1)))
            if prompt_logprobs:
                cd["prompt_logprob_err"] = max(cd["prompt_logprob_err"], float(
                    (_prompt_lp(c_rows, r.prompt) - ref_lp).abs().max()))
        del served, prows
    return out


def verdict(readings: Dict[str, float], limits: Dict[str, float]
            ) -> (bool, Dict[str, Dict[str, Optional[float]]]):
    """Each number beside its limit; correct when every number is at or
    under its limit and every limit has its number."""
    compared = {k: {"value": readings.get(k), "limit": lim}
                for k, lim in limits.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in compared.values())
    return ok, compared
