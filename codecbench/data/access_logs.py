"""Web-server access logs in the Apache httpd Combined Log Format
(https://httpd.apache.org/docs/2.4/logs.html#combined):

    %h %l %u %t "%r" %>s %b "%{Referer}i" "%{User-agent}i"

e.g. ``203.0.113.9 - - [14/Mar/2024:09:26:53 +0000] "GET /api/v2/items/
48213?page=3 HTTP/1.1" 200 5312 "https://www.example.com/shop" "Mozilla/
5.0 (...) Chrome/121.0.6167.85 Safari/537.36"``, one line each, cut at
the chunk's size as a rotated log is.

Chunk i of a pool is make_chunk(default_rng((seed, i)), chunk_bytes):
its vocabularies (clients, request paths, user agents, referers) are
drawn from that generator, and each line draws one entry of each with
Zipf popularity of exponent ZIPF (Breslau et al., "Web Caching and
Zipf-like Distributions", INFOCOM 1999, measured 0.64-0.83 over proxy
traces).  Timestamps never decrease, in steps of 0-2 s.  Lines are
assembled in bulk: every field is an entry of one table of byte strings,
a line is a fixed sequence of entries, and the chunk is one gather of
the table's bytes.
"""
from __future__ import annotations

import numpy as np

ZIPF = 0.8
CLIENTS = 4096
PATHS = 2048
AGENTS = 256
REFERERS = 512                 # plus "-", the commonest
METHODS = ((b"GET", 0.9), (b"POST", 0.1))
STATUSES = ((b"200", 0.80), (b"304", 0.08), (b"301", 0.04), (b"404", 0.06),
            (b"500", 0.02))
MAX_SIZE = 60000
STEP_S = (0, 1, 2)             # seconds between consecutive lines
MEAN_LINE = 240                # bytes, to size the first draw of lines

MONTHS = np.frombuffer(b"JanFebMarAprMayJunJulAugSepOctNovDec",
                       np.uint8).reshape(12, 3)
WORDS = ("api v1 v2 static img css js assets products items users account "
         "cart checkout search blog news posts tags category catalog media "
         "downloads docs help login logout orders reviews feed about")
EXTS = (".html", ".php", ".json", ".png", ".jpg", ".css", ".js", "", "",
        "")
QUERY_KEYS = ("id", "page", "q", "sort", "ref", "lang", "utm_source")
SITES = ("www.google.com", "www.bing.com", "duckduckgo.com", "t.co",
         "www.facebook.com", "news.ycombinator.com", "www.reddit.com")


def zipf_p(n: int, s: float = ZIPF) -> np.ndarray:
    """Popularity of ranks 1..n: proportional to rank ** -s."""
    w = np.arange(1, n + 1, dtype=np.float64) ** -s
    return w / w.sum()


def _clients(rng) -> list[bytes]:
    octets = rng.integers(1, 255, (CLIENTS, 4))
    return [b"%d.%d.%d.%d" % tuple(o) for o in octets.tolist()]


def _paths(rng) -> list[bytes]:
    words = WORDS.split()
    out = []
    for _ in range(PATHS):
        segs = [words[k] for k in rng.integers(0, len(words),
                                               rng.integers(1, 5))]
        kind = rng.integers(0, 3)
        if kind == 1:                          # an id in the path
            segs.append(str(rng.integers(1, 10 ** 6)))
        path = "/" + "/".join(segs) + EXTS[rng.integers(0, len(EXTS))]
        if kind == 2:                          # a query string
            keys = rng.choice(len(QUERY_KEYS), rng.integers(1, 3),
                              replace=False)
            path += "?" + "&".join(f"{QUERY_KEYS[k]}={rng.integers(1, 5000)}"
                                   for k in keys)
        out.append(path.encode())
    return out


def _agents(rng) -> list[bytes]:
    systems = ("Windows NT 10.0; Win64; x64", "Macintosh; Intel Mac OS X "
               "10_15_7", "X11; Linux x86_64", "iPhone; CPU iPhone OS 17_2 "
               "like Mac OS X", "Linux; Android 14; Pixel 8")
    out = []
    for _ in range(AGENTS):
        system = systems[rng.integers(0, len(systems))]
        major = rng.integers(100, 125)
        build = f"{major}.0.{rng.integers(4000, 6500)}.{rng.integers(0, 250)}"
        if rng.random() < 0.7:
            tail = f"Chrome/{build} Safari/537.36"
            if system.startswith("Windows") and rng.random() < 0.3:
                tail += f" Edg/{build}"
        else:
            tail = (f"Version/{rng.integers(14, 18)}.{rng.integers(0, 7)} "
                    f"Mobile/15E148 Safari/604.1")
        out.append(f"Mozilla/5.0 ({system}) AppleWebKit/537.36 (KHTML, like "
                   f"Gecko) {tail}".encode())
    return out


def _referers(rng, paths: list[bytes]) -> list[bytes]:
    out = [b"-"]
    for _ in range(REFERERS):
        if rng.random() < 0.6:                 # a page of the same site
            out.append(b"https://www.example.com"
                       + paths[rng.integers(0, len(paths))])
        else:
            site = SITES[rng.integers(0, len(SITES))]
            out.append(f"https://{site}/".encode())
    return out


def _timestamps(first: int, seconds: np.ndarray) -> np.ndarray:
    """uint8 [n, 28]: "[dd/Mon/yyyy:HH:MM:SS +0000]" of first + seconds
    (Unix time, UTC)."""
    t = (np.int64(first) + seconds).astype("datetime64[s]")
    iso = np.char.encode(np.datetime_as_string(t, unit="s"), "ascii")
    iso = np.frombuffer(iso.tobytes(), np.uint8).reshape(-1, 19)
    month = (iso[:, 5] - 48) * 10 + iso[:, 6] - 48 - 1
    out = np.empty((len(t), 28), np.uint8)
    out[:, 0] = ord("[")
    out[:, 1:3] = iso[:, 8:10]
    out[:, 3] = out[:, 7] = ord("/")
    out[:, 4:7] = MONTHS[month]
    out[:, 8:12] = iso[:, 0:4]
    out[:, 12] = ord(":")
    out[:, 13:21] = iso[:, 11:19]
    out[:, 21:28] = np.frombuffer(b" +0000]", np.uint8)
    return out


class _Table:
    """Byte strings in one buffer: entry k is buf[start[k]:start[k] +
    size[k]]."""

    def __init__(self):
        self.parts, self.sizes = [], []

    def add(self, strings) -> int:
        """Append the strings; the index of the first."""
        first = len(self.sizes)
        self.parts.extend(strings)
        self.sizes.extend(len(s) for s in strings)
        return first

    def add_fixed(self, rows: np.ndarray) -> int:
        """Append each row of a uint8 [n, w] array as an entry."""
        first = len(self.sizes)
        self.parts.append(rows.tobytes())
        self.sizes.extend([rows.shape[1]] * len(rows))
        return first

    def freeze(self):
        self.buf = np.frombuffer(b"".join(self.parts), np.uint8)
        self.size = np.asarray(self.sizes, np.int64)
        self.start = np.concatenate([[0], np.cumsum(self.size)[:-1]])

    def join(self, ids: np.ndarray) -> np.ndarray:
        """The entries ids (int64 [n]) concatenated, as uint8."""
        size = self.size[ids]
        ends = np.cumsum(size)
        offs = np.repeat(self.start[ids] - (ends - size), size)
        return self.buf[offs + np.arange(ends[-1] if len(ends) else 0)]


def _draw(rng, n: int, weights) -> np.ndarray:
    return rng.choice(len(weights), n, p=np.asarray(weights) / sum(weights))


def make_chunk(rng: np.random.Generator, nbytes: int) -> bytes:
    """nbytes of access log lines: the chunk's vocabularies, then the
    lines, cut at nbytes."""
    clients, paths = _clients(rng), _paths(rng)
    agents, referers = _agents(rng), _referers(rng, paths)
    path_size = np.exp(rng.uniform(np.log(200), np.log(MAX_SIZE), PATHS))
    first = int(rng.integers(1_600_000_000, 1_750_000_000))
    n = nbytes // MEAN_LINE + 1
    while True:
        lines = _lines(rng, n, first, clients, paths, agents, referers,
                       path_size)
        if len(lines) >= nbytes:
            return lines[:nbytes].tobytes()
        n *= 2


def _lines(rng, n, first, clients, paths, agents, referers, path_size):
    tab = _Table()
    c0, p0 = tab.add(clients), tab.add(paths)
    a0, r0 = tab.add(agents), tab.add(referers)
    m0 = tab.add([m + b" " for m, _ in METHODS])
    s0 = tab.add([b"\" " + s + b" " for s, _ in STATUSES])
    sz0 = tab.add([b"-"] + [b"%d" % k for k in range(1, MAX_SIZE + 1)])
    sep = {s: tab.add([s]) for s in (b" - - ", b" \"", b" HTTP/1.1",
                                     b"\" \"", b"\"\n")}
    seconds = np.cumsum(rng.choice(STEP_S, n))
    t0 = tab.add_fixed(_timestamps(first, seconds))
    tab.freeze()

    client = _draw(rng, n, zipf_p(CLIENTS))
    path = _draw(rng, n, zipf_p(PATHS))
    agent = _draw(rng, n, zipf_p(AGENTS))
    referer = _draw(rng, n, zipf_p(len(referers)))
    method = _draw(rng, n, [w for _, w in METHODS])
    status = _draw(rng, n, [w for _, w in STATUSES])
    # a 200 sends the path's page; a 304 sends nothing ("-"); the rest a
    # short error or redirect page
    size = np.where(status == 0, path_size[path],
                    rng.integers(150, 1500, n)).astype(np.int64)
    size = np.where(status == 1, 0, np.clip(size, 1, MAX_SIZE))
    ids = np.stack([
        c0 + client, np.full(n, sep[b" - - "]), t0 + np.arange(n),
        np.full(n, sep[b" \""]), m0 + method, p0 + path,
        np.full(n, sep[b" HTTP/1.1"]), s0 + status, sz0 + size,
        np.full(n, sep[b" \""]), r0 + referer, np.full(n, sep[b"\" \""]),
        a0 + agent, np.full(n, sep[b"\"\n"])], 1)
    return tab.join(ids.ravel())


def make_pool(seed: int, pool: int, chunk_bytes: int) -> list[bytes]:
    """Chunk i of the pool is make_chunk(default_rng((seed, i)))."""
    return [make_chunk(np.random.default_rng((seed, i)), chunk_bytes)
            for i in range(pool)]
