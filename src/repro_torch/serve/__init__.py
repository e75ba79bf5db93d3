from repro_torch.serve.serve_step import generate, make_serve_fns

__all__ = ["make_serve_fns", "generate"]
