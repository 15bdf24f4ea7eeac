"""`python -m horaedb_tpu_torch.server --config FILE [--device cuda]`."""

from horaedb_tpu_torch.server.main import main

if __name__ == "__main__":
    main()
