"""System `prove`: a SHA-256 proving service on sha2cq_tpu_torch.

Set-up, as the service does it once: the CQ tables and the SRS from the
configuration's fixed secret (served from the program's disk cache after
the first run in a checkout), the KZG parameters, keygen, the device h
module (prewarm_prover) and one proof of a request outside the window.
A request is `blocks` chained message blocks of random `word_bits`-bit
words drawn from (seed, index), with their chaining value as the public
instance; serving it is one create_proof on the card.

The check holds the key to this benchmark's: the sha256 of the key in
plain data (`export_key`) has to be the configuration's `key_sha256`, and
its tables have to be the plain tables (reference/sha2_tables.py); then
every proof of the window goes through the plain verifier
(reference/plonk_verify.py) against the plain chaining value of its blocks.
The control (`control`) is the prover with its quotient cut to 240 bits.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import random
from types import SimpleNamespace

from cardbench.reference import plonk_verify, sha2, sha2_tables
from cardbench.roofline import work

SPAN = "create_proof"


def _secret(config) -> int:
    return int(config["srs_secret"], 0)


def setup(config, traffic, seed, device):
    from sha2cq_tpu_torch import plonk
    from sha2cq_tpu_torch.models.sha import circuit32, setup32, tables32
    from sha2cq_tpu_torch.poly.kzg.params import ParamsKZG
    scheme = tables32.HalfScheme(config["word_bits"])
    k, secret = config["k"], _secret(config)
    tables, configs, b0, srs = setup32.build_sha256_setup(
        scheme, 1 << k, secret, cache=True)
    params = ParamsKZG.setup_from_toxic_waste(k, secret)
    cls = type(f"Sha256Circuit{scheme.word_bits}", (circuit32.Sha256Circuit,),
               {"SCHEME": scheme})
    layout = cls([[0] * 16] * config["blocks"], tables)
    vk = plonk.keygen_vk(params, layout)
    pk = plonk.keygen_pk(params, configs, b0, vk, layout)
    state = SimpleNamespace(config=config, traffic=traffic, seed=seed,
                            device=device, params=params, pk=pk, cls=cls,
                            tables=tables, srs_len=len(srs.g1),
                            word_bits=config["word_bits"])
    plonk.prewarm_prover(pk, device=device, **_route(config))
    serve(state, request(state, "warm-up"))
    return state


def _route(config) -> dict:
    """create_proof's h-route flags for the configuration's `h_route`."""
    return {"auto": {}, "butterfly": {"h_mxu": False},
            "monolithic": {"h_mxu": True, "h_cosets": False},
            "coset": {"h_mxu": True, "h_cosets": True}}[config["h_route"]]


def request(state, index):
    """The blocks of request `index` of the seed, their chaining value and
    the prover's rng seed."""
    rng = random.Random(f"{state.seed}:{index}")
    wb = state.word_bits
    blocks = [[rng.getrandbits(wb) for _ in range(16)]
              for _ in range(state.config["blocks"])]
    return SimpleNamespace(blocks=blocks, digest=sha2.chain(blocks, wb),
                           rng=f"{state.seed}:{index}:prover")


def serve(state, req) -> bytes:
    from sha2cq_tpu_torch import plonk
    circuit = state.cls(req.blocks, state.tables)
    return plonk.create_proof(
        state.params, state.pk, [circuit], [[req.digest]],
        rng=random.Random(req.rng), multiopen=state.config["multiopen"],
        device=state.device, **_route(state.config))


def export_key(state) -> dict:
    """The verifier's key in plain data: the constraint system, the fixed
    and permutation columns' values, the tables' values, the verifying
    key's transcript hash and commitments, and the SRS secret."""
    pk, vk = state.pk, state.pk.vk
    cs = vk.cs

    def expr(e):
        if e.kind == "const":
            return ["const", e.value]
        if e.kind in ("fixed", "advice", "instance"):
            return [e.kind, e.query_index]
        if e.kind == "challenge":
            return ["challenge", e.value.index]
        if e.kind in ("neg",):
            return ["neg", expr(e.a)]
        if e.kind == "scaled":
            return ["scaled", expr(e.a), e.value]
        if e.kind in ("sum", "prod"):
            return [e.kind, expr(e.a), expr(e.b)]
        raise ValueError(f"expression node {e.kind!r} in a keyed circuit")

    def point(p):
        return None if p is None else [p[0], p[1]]

    tables = {}
    for arg in cs.static_lookups:
        for tid in arg.table_ids:
            tables[tid.name] = list(pk.static_table_mapping[tid].values)
    return {
        "k": vk.domain.k, "n": vk.domain.n, "cs_degree": vk.cs_degree,
        "quotient_pieces": vk.domain.quotient_poly_degree,
        "num_advice": cs.num_advice_columns,
        "num_instance": cs.num_instance_columns,
        "advice_phase": list(cs.advice_column_phase),
        "challenge_phase": list(cs.challenge_phase),
        "num_advice_queries": list(cs.num_advice_queries),
        "advice_queries": [[c.index, r] for c, r in cs.advice_queries],
        "fixed_queries": [[c.index, r] for c, r in cs.fixed_queries],
        "instance_queries": [[c.index, r] for c, r in cs.instance_queries],
        "gates": [expr(p) for g in cs.gates for p in g.polys],
        "permutation_columns": [[c.kind, c.index]
                                for c in cs.permutation.columns],
        "lookups": len(cs.lookups),
        "static_lookups": [[t.name for t in a.table_ids]
                           for a in cs.static_lookups],
        "zk_static_lookups": bool(getattr(cs, "zk_static_lookups", False)),
        "tables": tables,
        "fixed_values": [list(c) for c in pk.fixed_values],
        "sigma_values": [list(c) for c in pk.permutation.permutations],
        "fixed_commitments": [point(p) for p in vk.fixed_commitments],
        "permutation_commitments": [point(p)
                                    for p in vk.permutation_commitments],
        "transcript_repr": vk.transcript_repr,
        "srs_len": state.srs_len,
        "secret": _secret(state.config),
    }


def key_sha256(key: dict) -> str:
    """The sha256 of a key's canonical JSON."""
    text = json.dumps(key, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(text.encode()).hexdigest()


@contextlib.contextmanager
def control(state):
    """The program's prover with its quotient h cut to 240 bits on the card
    (the top 16-bit limb of its Montgomery form dropped): the exactness
    guarantee broken as a lower precision would break it."""
    from sha2cq_tpu_torch.plonk import device_eval as DE
    real = DE.get_h_fn

    class Cut:
        def __init__(self, fn):
            self.fn = fn

        def __getattr__(self, name):
            return getattr(self.fn, name)

        def __call__(self, *args):
            h, advice = self.fn(*args)
            h = h.clone()
            h[-1] = 0
            return h, advice

    DE.get_h_fn = lambda *a, **kw: Cut(real(*a, **kw))
    try:
        yield
    finally:
        DE.get_h_fn = real


def check(state, served) -> dict:
    """The key against this benchmark's and the plain tables, then every
    proof of the window through the plain verifier against its request's
    own chaining value; returns {name: (number, limit)}."""
    key = export_key(state)
    state.work = work.h_shape(key)
    state.pk = state.params = None
    digest = key_sha256(key)
    plain = sha2_tables.tables(state.word_bits)
    tables_differ = len(set(plain) ^ set(key["tables"])) + sum(
        key["tables"][name] != values for name, values in plain.items()
        if name in key["tables"])
    state.findings = [f"key sha256 {digest}"]
    if digest != state.config["key_sha256"]:
        state.findings.append("the key is not the configuration's key_sha256")
    prep = plonk_verify.prepare(key)
    rejected = 0
    for i, (req, proof) in enumerate(served):
        try:
            plonk_verify.verify(key, prep, [sha2.chain(req.blocks,
                                                      state.word_bits)], proof)
        except plonk_verify.Reject as e:
            rejected += 1
            state.findings.append(f"proof {i} rejected: {e}")
    state.findings.append(f"{len(served)} proofs checked")
    return {"key_differs": (int(digest != state.config["key_sha256"]), 0),
            "tables_differ": (tables_differ, 0),
            "proofs_rejected": (rejected, 0)}
