"""Port of benchmarks/wire_bench.py: concurrent RESP FT.SEARCH against
the port's server on one CUDA card.

    python3 -m redisearch_tpu_torch.bench.wire_bench [--docs N]
        [--conns C] [--warm W] [--each Q] [--reps R]

The script's shape (`workloads.wire_corpus`, `workloads.wire_cmds`):
`FT.CREATE bench SCHEMA t TEXT b TEXT` over the wire, 200,000 docs (a
4-word `t` and an 8-word `b` over 5,000 words `w%05d`, seed 0) through
`srv.client._index("bench").add_documents`, 32 connections, every query
`FT.SEARCH bench "<w_a> <w_b>" NOCONTENT DIALECT 2` with the script's
index formulas, then the sanity query `FT.SEARCH bench w00100 LIMIT 0 3
NOCONTENT`.  Each of `--reps` (default 3) reps is the script's run on
queries of its own (its query index i offset by rep x 60): a warm pass
of the first 20 queries a connection, then the timed pass of 60.  So
every timed pass starts from the script's state: the index's
prepared-query cache holds a third of its queries, as the script's warm
pass leaves it, and none of its other queries.  The port's `Server`,
with its defaults, serves on the event loop that runs the client
coroutines, as in the script: they share the loop and the GIL.

Parity, checked before any number is recorded: every reply of every
timed pass equals `Client.ft_search_many`'s result for its query, in
total and keys (`workloads.same_keys`: lane for lane, or, where the
served scores tie, the same keys as a set; a micro-batch of one runs
`ft_search`, the window program), and the sanity total equals
`ix.search`'s.

Prints nvidia-smi's name and power limit, progress on stderr, and as its
last line one JSON object: `wire_qps` (the median pass: queries over
the host seconds from the first send to the last reply), `spread`
(median, min, max, n), `batch_sizes` (`Server.batch_sizes`, the
micro-batch sizes of each timed pass: size -> groups), `routes` (the
batched queries' executors over the timed passes), `build_s`,
`sanity_total`, `passes_qps` (each pass's), `parity` and `device`.
It runs on `cuda:0` and raises without a card; `--device cpu` (the
tests' way) runs it on the CPU, where `device` says "cpu" and no number
is a card's.
"""

from __future__ import annotations

import argparse
import asyncio
import time

import redisearch_tpu_torch as rt
from redisearch_tpu_torch.bench import workloads as W
from redisearch_tpu_torch.query import engine as E
from redisearch_tpu_torch.server import Server

#: the largest k of the wider result a tie at the last lane is read from
WIDE_K = 1000


async def _session(client, docs, words, n_conns, n_warm, n_each, reps):
    srv = Server(client=client, port=0)
    tcp = await srv.serve()
    port = tcp.sockets[0].getsockname()[1]
    conns = []
    try:
        c0 = await W.WireConn.open(port)
        conns.append(c0)
        await c0.cmd("FT.CREATE", "bench", "SCHEMA", "t", "TEXT", "b",
                     "TEXT")
        t0 = time.perf_counter()
        srv.client._index("bench").add_documents(docs)
        build_s = time.perf_counter() - t0
        pool = [await W.WireConn.open(port) for _ in range(n_conns)]
        conns += pool
        passes, routes = [], {}
        for rep in range(reps):
            # each rep is the script's run on queries of its own: a warm
            # pass of its first n_warm a connection, then the timed pass
            start = rep * n_each
            await W.wire_pass(pool, W.wire_cmds(words, n_conns, n_warm,
                                                start))
            cmds = W.wire_cmds(words, n_conns, n_each, start)
            srv.batch_sizes.clear()
            before = dict(E.QUERY_PATH_STATS)
            replies, dt = await W.wire_pass(pool, cmds)
            for r, n in W.route_delta(before, E.QUERY_PATH_STATS).items():
                routes[r] = routes.get(r, 0) + n
            passes.append((cmds, replies, dt, dict(sorted(
                srv.batch_sizes.items()))))
        sanity = await c0.cmd("FT.SEARCH", "bench", words[100], "LIMIT",
                              "0", "3", "NOCONTENT")
    finally:
        await W.close_conns(conns)
        tcp.close()
        await tcp.wait_closed()
        await srv.aclose()
        srv._pool.shutdown(wait=True)
    return passes, routes, sanity, build_s


def measure(dev, n_docs=W.WIRE_N, n_conns=W.WIRE_CONNS,
            n_warm=W.WIRE_WARM, n_each=W.WIRE_EACH, reps=3) -> dict:
    """wire_bench.py's run on `dev`, each timed pass held against
    `ft_search_many`.  Returns the record (`main`'s JSON but `device`)
    with the last pass's replies and the sanity reply under `served`."""
    docs, words = W.wire_corpus(n_docs)
    client = rt.Client(device=dev)
    passes, routes, sanity, build_s = asyncio.run(_session(
        client, docs, words, n_conns, n_warm, n_each, reps))
    del docs
    queries = sorted({c[2] for cmds, *_r in passes for c in cmds})
    want = dict(zip(queries, client.ft_search_many("bench", queries, k=10,
                                                   dialect=2)))

    def wide(q):
        return lambda: client.ft_search_many(
            "bench", [q], k=min(max(want[q].total, 10), WIDE_K),
            dialect=2)[0]

    n_exact = 0
    for p, (cmds, replies, _dt, _h) in enumerate(passes):
        for c, rep in zip(cmds, replies):
            n_exact += W.same_keys(rep, want[c[2]],
                                   f"wire pass {p} {c[2]!r}", wide(c[2]))
    single = client._index("bench").search(words[100], num=3)
    if sanity[0] != single.total:
        raise AssertionError(f"wire: sanity total {sanity[0]} != "
                             f"ix.search's {single.total}")
    n_q = n_conns * n_each
    qps = [n_q / dt for _c, _r, dt, _h in passes]
    out = {"wire_qps": W.spread(qps)["median"], "spread": W.spread(qps),
           "passes_qps": qps,
           "batch_sizes": [h for *_r, h in passes], "routes": routes,
           "build_s": build_s, "sanity_total": sanity[0],
           "docs": n_docs, "connections": n_conns, "queries_a_pass": n_q,
           "parity": {"checked": n_q * len(passes),
                      "against": "Client.ft_search_many",
                      "equal": "totals and keys", "keys_equal": n_exact,
                      "sanity": "total == ix.search's"},
           "served": {"cmds": passes[-1][0], "replies": passes[-1][1],
                      "sanity": sanity}}
    W.log(f"wire: {n_docs} docs indexed in {build_s:.1f}s; "
          f"{out['spread']} qps over {n_conns} connections, "
          f"micro-batches {out['batch_sizes'][-1]}, routes {routes}, "
          f"{n_exact} of {n_q * len(passes)} replies key for key")
    return out


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python3 -m redisearch_tpu_torch.bench.wire_bench",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=W.WIRE_N)
    ap.add_argument("--conns", type=int, default=W.WIRE_CONNS)
    ap.add_argument("--warm", type=int, default=W.WIRE_WARM)
    ap.add_argument("--each", type=int, default=W.WIRE_EACH)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=device,
                    help="cpu: run on the CPU (tests only)")
    a = ap.parse_args(argv)
    dev = W.open_device(a.device)
    return W.emit(measure(dev, a.docs, a.conns, a.warm, a.each, a.reps), dev)


if __name__ == "__main__":
    main()
