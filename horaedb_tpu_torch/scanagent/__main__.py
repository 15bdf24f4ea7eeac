"""Standalone near-data scan agent: serve aggregate partials for the
SSTs under a local object-store directory.

    python -m horaedb_tpu_torch.scanagent --data-dir /data/shard0 --port 9201 \
        [--device cuda]

The agent's reader runs on the card unless `--device cpu` is given; it
refuses to start without a card otherwise.

Coordinators auto-register tables over POST /v1/tables, so the agent
needs no schema configuration of its own — point it at the shard's
bytes and add it to the coordinator's [scanagent] map.
"""

from __future__ import annotations

import argparse
import asyncio
import logging


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="near-data scan agent")
    parser.add_argument("--data-dir", required=True,
                        help="local object-store root this agent serves")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=9201)
    parser.add_argument("--max-partial-bytes", type=int,
                        default=32 << 20)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the agent's reader "
                             "(default: cuda)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    async def run() -> None:
        from horaedb_tpu_torch.objstore import LocalObjectStore
        from horaedb_tpu_torch.scanagent import AgentService, ScanAgentConfig

        service = AgentService(
            LocalObjectStore(args.data_dir),
            config=ScanAgentConfig(
                max_partial_bytes=args.max_partial_bytes),
            device=args.device)
        url = await service.start(args.host, args.port)
        logging.getLogger(__name__).info("scanagent serving at %s", url)
        try:
            await asyncio.Event().wait()
        finally:
            await service.close()

    asyncio.run(run())


if __name__ == "__main__":
    main()
