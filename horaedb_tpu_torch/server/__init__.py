"""HTTP server + config (ref: src/server): the engine's HTTP API over
aiohttp, its engine on the card unless asked for the CPU."""

from horaedb_tpu_torch.server.config import ServerConfig, load_config

__all__ = ["ServerConfig", "load_config"]
