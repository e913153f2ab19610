"""Closed-loop streamed requests: each client sends its next request when
the final packet of its last one arrives, with no think time.

The request with global index k (in submission order) is a pure function
of (seed, k). Requests come in blocks of `clients`: each block holds the
same `clients` output lengths, at the quantiles of a log-uniform law, in an
order the seed draws for that block, so every seed (and every stretch of a
run) offers the same sizes in another order. Every `greedy_every`-th request
(k = 0, G, 2G, ...) decodes greedily (talker and sub-talker), so that its
served tokens can be held to the reference's best; the others sample with
the server's defaults. The task's own inputs (a speaker, a reference clip)
come from the mix's task file (`portbench/tasks/<task>.py`).

Traffic parameters (the mix's JSON file):
  task               the task file's name
  clients            closed-loop clients
  frames             {"low", "high"}: the request's frame budget
                     (`max_frames`), log-uniform between the two
  frames_per_word    frames of output per text word
  language           the request's language
  greedy_every       one greedy request in this many
  check_requests     requests of each kind (greedy, sampled) the check draws
                     (portbench/check.py)
  server             the TTSServer's settings (the rest are its defaults);
                     `overrides` {"min_new_tokens": max_new_tokens} bans EOS
                     until the budget, so every request runs its drawn length
  source, departures what the laws are taken from, and where the mix departs
                     from it (read by no code)
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np

from portbench.text import ORDINARY_IDS, words_text


class Traffic:
    def __init__(self, params: Dict[str, Any], seed: int, config: Dict[str, Any], task):
        self.p, self.config, self.task = params, config, task
        self.seed = int(seed)
        self.clients = int(params["clients"])
        lo, hi = math.log(params["frames"]["low"]), math.log(params["frames"]["high"])
        q = (np.arange(self.clients) + 0.5) / self.clients
        self.lengths = np.round(np.exp(lo + q * (hi - lo))).astype(int)
        self.language = params.get("language")

    def request(self, k: int) -> Dict[str, Any]:
        """The k-th request: `kwargs` for the task's submit call, and what
        the check needs to rebuild it."""
        p = self.p
        block, i = divmod(k, self.clients)
        order = np.random.default_rng([self.seed, 1, block]).permutation(self.clients)
        frames = int(self.lengths[order[i]])
        rng = np.random.default_rng([self.seed, 2, k])
        n_words = max(1, math.ceil(frames / float(p["frames_per_word"])))
        words = rng.integers(0, ORDINARY_IDS, n_words).tolist()
        greedy = k % int(p["greedy_every"]) == 0
        kw: Dict[str, Any] = {"text": words_text(words), "language": self.language,
                              "stream": True, "max_frames": frames}
        if greedy:
            kw.update(do_sample=False, subtalker_do_sample=False)
        task_kw, task_req = self.task.request_fields(rng, self.config)
        kw.update(task_kw)
        return dict(task_req, index=k, greedy=greedy, words=words, max_frames=frames,
                    language=self.language, kwargs=kw)
