"""Serve canny2image over HTTP with cross-request batching on the card
(counterpart of stablediffusioneo_tpu/cli/serve.py).

Loads a checkpoint (or seeded tiny weights with --tiny), wraps the pipeline
in a DiffusionServer and exposes it through the stdlib HTTP API
(serving/http_api.py). Concurrent clients batch onto the card.

  python -m stablediffusioneo_tpu_torch.cli.serve --ckpt control_sd15_canny.pth \\
      --vocab vocab.json --merges merges.txt --warmup-res 512 --port 8000
  python -m stablediffusioneo_tpu_torch.cli.serve --tiny --cpu --port 8000

  curl -s localhost:8000/healthz
  curl -s localhost:8000/stats
  curl -s -X POST localhost:8000/generate -d \\
      '{"image_b64": "<base64 png>", "prompt": "a bird", "seed": 1}'
"""

import argparse


def build_pipeline(args):
    """The Canny2ImagePipeline the flags ask for, on the card unless --cpu."""
    import torch

    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    device = "cpu" if args.cpu else "cuda"
    if args.tiny:
        from stablediffusioneo_tpu_torch.config import tiny_pipeline
        from stablediffusioneo_tpu_torch.models.cldm import ControlLDM, init_weights
        from stablediffusioneo_tpu_torch.models.tokenizer import toy_tokenizer

        cfg = tiny_pipeline()
        model = ControlLDM(cfg)
        init_weights(model, torch.Generator().manual_seed(0))
        tok = toy_tokenizer(vocab_size=cfg.clip.vocab_size,
                            max_length=cfg.clip.max_length)
        return Canny2ImagePipeline(model, tok, cfg, device=device)

    from stablediffusioneo_tpu_torch.checkpoint import load_controlnet_pipeline
    from stablediffusioneo_tpu_torch.config import sd15_pipeline
    from stablediffusioneo_tpu_torch.models.tokenizer import CLIPTokenizer

    cfg = sd15_pipeline(dtype=args.dtype)
    model = load_controlnet_pipeline(args.ckpt, cfg, device=device)
    tok = CLIPTokenizer.from_hf_files(args.vocab, args.merges)
    return Canny2ImagePipeline(model, tok, cfg, device=device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", help="control_sd15_canny.pth path")
    ap.add_argument("--vocab", help="CLIP vocab.json path")
    ap.add_argument("--merges", help="CLIP merges.txt path")
    ap.add_argument("--tiny", action="store_true",
                    help="seeded tiny weights (smoke / demo)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--buckets", default="1,2,4",
                    help="engine batch buckets, comma-separated")
    ap.add_argument("--wait-ms", type=float, default=25.0,
                    help="batching window (latency a lone request may pay)")
    ap.add_argument("--warmup-res", default="",
                    help="comma-separated resolutions to capture engines for, e.g. 512")
    ap.add_argument("--warmup-steps", type=int, default=20)
    args = ap.parse_args(argv)
    if not args.tiny and not (args.ckpt and args.vocab and args.merges):
        ap.error("--ckpt/--vocab/--merges required (or use --tiny)")
    return args


def main(argv=None):
    args = parse_args(argv)

    from stablediffusioneo_tpu_torch.serving import DiffusionServer
    from stablediffusioneo_tpu_torch.serving.http_api import make_http_server

    pipe = build_pipeline(args)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    server = DiffusionServer(pipe, batch_buckets=buckets,
                             max_wait_ms=args.wait_ms).start()
    if args.warmup_res:
        res = tuple(int(r) for r in args.warmup_res.split(","))
        print(f"warmup: capturing {len(buckets)}x{len(res)} engines ...", flush=True)
        server.warmup(resolutions=res, steps=args.warmup_steps)
    httpd = make_http_server(server, host=args.host, port=args.port)
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          f"(buckets {buckets}, wait {args.wait_ms} ms)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.stop(drain=False)


if __name__ == "__main__":
    main()
