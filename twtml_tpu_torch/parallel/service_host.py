"""An elastic epoch's store in a process of its own (counterpart of
``twtml_tpu/parallel/service_host.py``).

A lockstep group's ``TCPStore`` lives in rank 0's process, so it dies with
rank 0, and the next epoch could not form on it. Under ``--elastic on``
each epoch's pid-0 member spawns this process instead
(parallel/elastic.py ``ElasticRuntime.form``): it hosts the epoch's store
(``TCPStore(is_master=True)``) and survives the death of any member,
its spawner included.

Lifetime: the members cannot reap it (it is there to outlive them), so it
watches the membership beacon's port, the one address that stays bound
across elections (the winner re-binds it within seconds of a lead's
death). Once the beacon has been unreachable for ``linger_s`` straight
(``TWTML_ELASTIC_SERVICE_LINGER_S``, default 45 s, well past an election
and a rescue), the run is over and this process exits.

It imports torch's distributed store and nothing else of torch's: it owns
no device and never initializes CUDA.

Usage: python -m twtml_tpu_torch.parallel.service_host <port> <nprocs> \
           <beacon_host> <beacon_port> [linger_s]
"""

from __future__ import annotations

import datetime
import os
import socket
import sys
import time

LINGER_ENV = "TWTML_ELASTIC_SERVICE_LINGER_S"
LINGER_DEFAULT_S = 45.0
# how long the store waits on a key a member asks for
_STORE_TIMEOUT_S = 300.0


def _beacon_up(host: str, port: int) -> bool:
    try:
        with socket.create_connection((host, port), timeout=0.5):
            return True
    except OSError:
        return False


def main(argv: "list[str] | None" = None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    port, nprocs = int(args[0]), int(args[1])
    beacon_host, beacon_port = args[2], int(args[3])
    linger_s = float(args[4]) if len(args) > 4 else float(
        os.environ.get(LINGER_ENV, "") or LINGER_DEFAULT_S)
    from torch.distributed import TCPStore

    store = TCPStore(beacon_host, port, nprocs, is_master=True,
                     timeout=datetime.timedelta(seconds=_STORE_TIMEOUT_S),
                     wait_for_workers=False)
    last_ok = time.monotonic()
    while True:
        time.sleep(2.0)
        if _beacon_up(beacon_host, beacon_port):
            last_ok = time.monotonic()
        elif time.monotonic() - last_ok > linger_s:
            break
    del store
    os._exit(0)


if __name__ == "__main__":
    main()
