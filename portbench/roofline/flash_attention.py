"""`flash_attention`: q [B, H, Sq, D] over k, v [B, Hkv, Sk, D]; a causal
mask keeps key j <= query i.  Operations: 4 D a (query, key) pair (the two
products); bf16 at the bf16 tensor-core rate, float32 as its route
computes it, three TF32 products a product.  Bytes: q, k, v read once, the
output written once, and the segment ids."""

WRAP = ("anakin_tpu_torch.kernels.flash_attention", "_flash_attention")
MAIN = (r"flash_wgmma", r"flash_bf16", r"flash_tf32")
AUX = ()


def key(q, k, v, q_segment_ids, kv_segment_ids, *, causal, **_):
    """(B, H, Hkv, Sq, Sk, D, element bytes, causal, rows of each batch
    row's segment 0 or None).  Where segment ids are given, the lengths are
    read back (a host sync, in traced runs only), so that only the pairs a
    row's segment holds are counted."""
    B, H, Sq, D = q.shape
    lens = None
    if q_segment_ids is not None:
        lens = tuple(int(n) for n in (q_segment_ids == 0).sum(1).tolist())
    return (int(B), int(H), int(k.shape[1]), int(Sq), int(k.shape[2]), int(D),
            int(q.element_size()), bool(causal), lens)


def pairs(Sq: int, Sk: int, causal: bool) -> int:
    """(query, key) pairs of one head over Sq queries and Sk keys."""
    if not causal:
        return Sq * Sk
    n = min(Sq, Sk)  # rows i < Sk see i + 1 keys, the rest all Sk
    return n * (n + 1) // 2 + (Sq - n) * Sk


def cost(key):
    B, H, Hkv, Sq, Sk, D, esize, causal, lens = key
    if lens is None:
        n_pairs = B * pairs(Sq, Sk, causal)
    else:
        n_pairs = sum(pairs(n, n, causal) for n in lens)
    ops = 4 * H * D * n_pairs
    nbytes = (2 * B * H * Sq * D + 2 * B * Hkv * Sk * D) * esize
    if lens is not None:
        nbytes += 2 * 4 * B * Sq
    if esize == 2:
        return ops, nbytes, "bf16"
    return 3 * ops, nbytes, "tf32"
