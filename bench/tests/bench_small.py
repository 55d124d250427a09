"""Small sizes of the benchmark's configurations and mixes, for the CPU
tests: every width cut, every other number as the cell's files have it."""

from bench import spec, traffic


def config(name: str) -> dict:
    c = dict(spec.config(name))
    c.update(num_layers=2, d_model=64, num_heads=4,
             num_kv_heads=2 if c["causal"] else 4, head_dim=16, d_ff=128,
             vocab_size=251 if c["causal"] else 63)
    return c


def mix(name: str) -> dict:
    m = traffic.load(name)
    if m["kind"] == "train":
        m.update(batch=2, seq_len=64)
    else:
        m.update(clients=4, warmup_requests=4,
                 prompt={"median": 24, "sigma": 0.8, "min": 4, "max": 48},
                 output={"median": 4, "sigma": 1.0, "min": 2, "max": 16},
                 pages=dict(m["pages"], num_pages=17, max_batch=4,
                            max_pages_per_seq=4),
                 engine=dict(m["engine"], prefill_len=64))
    return m


def cell(name: str) -> dict:
    return spec.cell(spec.benchmark(), name)
