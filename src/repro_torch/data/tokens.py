"""Synthetic non-IID token streams for the LM architectures; a copy of
the reference's ``repro/data/tokens.py`` (numpy only), so that the same
generator gives the same arrays.

Each federated client draws from a Zipf distribution over the vocab through
a client-specific permutation seeded by its "domain" — clients in the same
domain share token statistics (IID within, non-IID across), mirroring the
label-sorted image partition at LM scale.
"""
from __future__ import annotations

import numpy as np


def client_token_stream(rng: np.random.Generator, vocab: int, domain: int,
                        n_tokens: int, zipf_a: float = 1.2):
    perm_rng = np.random.default_rng(domain)
    perm = perm_rng.permutation(vocab)
    raw = rng.zipf(zipf_a, size=n_tokens)
    return perm[np.clip(raw, 1, vocab) - 1].astype(np.int32)


def fed_lm_batches(rng: np.random.Generator, *, vocab: int, n_clients: int,
                   local_epochs: int, batch: int, seq: int,
                   n_domains: int = 4, codebooks: int = 0):
    """One round of batches: tokens/labels (C, E, b, S[, K])."""
    shape_tail = (codebooks,) if codebooks else ()
    toks = np.empty((n_clients, local_epochs, batch, seq + 1) + shape_tail,
                    np.int32)
    for c in range(n_clients):
        dom = c % n_domains
        n_tok = local_epochs * batch * (seq + 1) * max(1, codebooks)
        stream = client_token_stream(rng, vocab, dom, n_tok)
        toks[c] = stream.reshape((local_epochs, batch, seq + 1) + shape_tail)
    return {"tokens": toks[:, :, :, :-1], "labels": toks[:, :, :, 1:]}
