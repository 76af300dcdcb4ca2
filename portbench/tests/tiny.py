"""Small versions of the cells for the CPU tests: the same code paths at
widths a test run can hold."""

from portbench import spec

A = "resnet50_int8.offline_b256"
B = "internlm2_1_8b_w4.decode_closed16"
C = "internlm2_1_8b_w4.prompt_open"

TINY_DECODER = dict(hidden_size=256, num_attention_heads=2,
                    num_key_value_heads=1, num_hidden_layers=2,
                    intermediate_size=512, vocab_size=512,
                    max_position_embeddings=256, slots=4, fuse_window=4)


# the control's test: at TINY_DECODER's two layers and 512 tokens the
# float8 control's mean gap reads 0.006-0.03, too near the cells' limit to
# come out the same on every seed; four layers and 8,192 tokens read
# 0.016-0.046 over ten seeds of B and C
CONTROL_DECODER = dict(num_hidden_layers=4, vocab_size=8192)


def cell(name: str, control: bool = False) -> spec.Cell:
    """The small version of cell `name`; `control`: sized for the
    lower-precision control's test."""
    c = spec.load_cell(name)
    if name == A:
        c.config.update(image_size=64)
        c.traffic.update(batch=2, ring=2, check_steps=2,
                         trace_seconds=1.0)
    elif name == B:
        c.config.update(TINY_DECODER)
        c.traffic.update(
            clients=4, pool=64, warmup=[[20, 3], [60, 3]],
            check_requests=6, check_prefix=8,
            prompt=dict(dist="lognormal", median=12, sigma=0.5, min=4, max=30),
            new_tokens=dict(dist="uniform", min=8, max=24),
            trace_seconds=1.0)
    else:
        c.config.update(TINY_DECODER)
        c.traffic.update(
            rate_per_s=4.0, pool=64, warmup=[[20, 3], [100, 3]],
            check_requests=6, check_prefix=8,
            prompt=dict(dist="lognormal", median=40, sigma=0.5, min=10,
                        max=100),
            new_tokens=dict(dist="uniform", min=4, max=10),
            trace_seconds=1.0)
    if control and name != A:
        c.config.update(CONTROL_DECODER)
        c.traffic.update(check_requests=10, check_prefix=24)
    return c
