"""Checker 15: donation safety for distributed and batched graphs (SA015),
the rules of ``spfft_tpu/analysis/donation_dist.py`` over the port's IR.

SA012 guards the per-request local backward donation. The batch axis and
the mesh lowerings widen the surface it cannot see:

* **Batched/mesh consume-once.** Every lowered backward graph declares its
  per-request edges (``g.batch_inputs`` — the packed value pair). On the
  batched path those edges are the STACKED buffers a batched program
  slices per request (and the JAX package donates), and on mesh graphs the
  per-shard blocks — so in EVERY ``_lower_*`` backward graph (local, slab,
  pencil) a declared batch edge must be consumed by at most one node and
  never escape via ``set_outputs``.
* **Donate only per-request edges.** The local donated edges (``_ir_spec``
  positions, or the card's donation map) must be edges listed in the
  backward graph's ``batch_inputs``: donating a SHARED plan constant (an
  index table, a phase operand) would let one batch's execution free
  memory every later batch still reads.
* **The batched path mirrors the per-request rule.** In the JAX form,
  ``build_batched`` applies ``donate_argnums`` from the same spec key
  ``build_fused`` does. In the port's form, the batched program body
  (``_batched`` in ``ir/compile.py``) stacks exactly the per-request
  edges: it must choose the inputs it slices per request by the graph's
  ``batch_inputs`` — a body that slices anything else runs shared plan
  constants per request, or shares a per-request edge across the batch.

Reconstruction is the SA012 machinery (literal ``add_input``/``add``/
``set_outputs``/``batch_inputs`` calls, string-constant propagation;
non-literal nodes skipped, conservative).
"""
from __future__ import annotations

import ast

from .core import Tree, checker, missing_anchor
from .donation import (
    IR_COMPILE_FILE,
    IR_LOWER_FILE,
    _reconstruct,
    _spec_keys,
    card_donation,
    donated_edges,
    donated_positions,
)

BUILDER_PREFIX = "_lower_"
BATCH_BODY = "_batched"


def _donate_keys_of(compile_mod, fn_name: str) -> tuple:
    """(applied, spec keys feeding donate_argnums) for one build function."""
    keys: set = set()
    applied = False
    for node in ast.walk(compile_mod):
        if not (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name == fn_name
        ):
            continue
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            for kw in call.keywords:
                if kw.arg != "donate_argnums":
                    continue
                applied = True
                names = {
                    n.id for n in ast.walk(kw.value)
                    if isinstance(n, ast.Name)
                }
                for stmt in ast.walk(node):
                    if isinstance(stmt, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id in names
                        for t in stmt.targets
                    ):
                        keys |= _spec_keys(stmt.value)
                keys |= _spec_keys(kw.value)
    return applied, keys


@checker(
    "donation-batch",
    code="SA015",
    doc="Donation safety beyond the local backward (SA012): in EVERY "
    "lowered backward graph (local, slab, pencil) the declared "
    "batch_inputs edges — the per-request value pair a batched program "
    "stacks, and the per-shard blocks of mesh graphs — are consumed by at "
    "most one node and never escape via set_outputs; the local donated "
    "edges (_ir_spec positions or the card's donation map) name only "
    "batch_inputs edges (donating a shared plan constant frees memory "
    "every later batch still reads); and the batched path mirrors the "
    "per-request rule: build_batched applies donate_argnums from the same "
    "spec key build_fused does, and the batched body (_batched) slices "
    "exactly the graph's batch_inputs. Reconstructed from literal "
    "graph-build calls, conservative like SA012.",
)
def check_donation_batch(tree: Tree):
    findings = []
    for anchor in (IR_LOWER_FILE, IR_COMPILE_FILE):
        skip, f = missing_anchor(check_donation_batch, tree, anchor)
        if skip:
            return findings + f
        findings += f
    positions = donated_positions(tree)
    compile_mod = tree.parse(IR_COMPILE_FILE)
    _literal, card_edges = card_donation(compile_mod)

    # ---- rule 1 + 2: batch edges consume-once / never-escape; donated
    # positions are batch edges --------------------------------------------
    lower_mod = tree.parse(IR_LOWER_FILE)
    for builder in lower_mod.body:
        if not (
            isinstance(builder, (ast.FunctionDef, ast.AsyncFunctionDef))
            and builder.name.startswith(BUILDER_PREFIX)
        ):
            continue
        local = builder.name.startswith("_lower_local")
        for g in _reconstruct(builder):
            if g.direction != "backward" or not g.batch:
                continue
            for edge in sorted(g.batch):
                uses = [
                    (possible, lineno)
                    for possible, lineno in g.consumers
                    if edge in possible
                ]
                for _possible, lineno in uses[1:]:
                    findings.append(
                        check_donation_batch.finding(
                            IR_LOWER_FILE, lineno,
                            f"batched input edge {edge!r} referenced after "
                            f"its consuming node in a {builder.name} "
                            "backward graph — the batched consuming jit "
                            "donates the stacked buffer at that node",
                        )
                    )
                if edge in g.outputs:
                    findings.append(
                        check_donation_batch.finding(
                            IR_LOWER_FILE, g.lineno,
                            f"batched input edge {edge!r} escapes as a "
                            f"graph output of a {builder.name} backward "
                            "graph",
                        )
                    )
            if local:
                for edge, why in donated_edges(g, positions, card_edges):
                    if edge not in g.batch:
                        findings.append(
                            check_donation_batch.finding(
                                IR_LOWER_FILE, g.lineno,
                                f"{why} names input edge "
                                f"{edge!r}, which is not a declared "
                                f"batch_inputs edge of a {builder.name} "
                                "backward graph — donating a shared plan "
                                "constant frees memory every later batch "
                                "still reads",
                            )
                        )

    # ---- rule 3: the batched path mirrors the per-request rule -------------
    for node in ast.walk(compile_mod):
        if not (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name == BATCH_BODY
        ):
            continue
        if not any(
            isinstance(sub, ast.Attribute) and sub.attr == "batch_inputs"
            for sub in ast.walk(node)
        ):
            findings.append(
                check_donation_batch.finding(
                    IR_COMPILE_FILE, node.lineno,
                    f"the batched program body {BATCH_BODY} does not choose "
                    "the inputs it slices per request by the graph's "
                    "batch_inputs — the batched path no longer stacks "
                    "exactly the per-request edges",
                )
            )
    fused_applied, fused_keys = _donate_keys_of(compile_mod, "build_fused")
    batch_applied, batch_keys = _donate_keys_of(compile_mod, "build_batched")
    if fused_applied and not batch_applied:
        findings.append(
            check_donation_batch.finding(
                IR_COMPILE_FILE, 0,
                "build_fused donates the consuming backward's buffers but "
                "build_batched passes no donate_argnums — the batched path "
                "silently stopped donating (doubled peak value memory per "
                "batch)",
            )
        )
    if (
        fused_applied
        and batch_applied
        and fused_keys
        and batch_keys
        and fused_keys != batch_keys
    ):
        findings.append(
            check_donation_batch.finding(
                IR_COMPILE_FILE, 0,
                f"build_batched donates from spec key(s) "
                f"{sorted(batch_keys)} but build_fused donates from "
                f"{sorted(fused_keys)} — the stacked donation no longer "
                "mirrors the per-request rule",
            )
        )
    return findings
