"""Fixture: TF32 turned on around a float32 product (T6).

``bad_gram`` switches TF32 on and runs a float32 matmul under it: the
switch is flagged by the AST layer, the product by the trace layer.
``good_gram`` is the twin that keeps float32 products in float32.
"""
import torch


def bad_gram(x):
  torch.backends.cuda.matmul.allow_tf32 = True  # BUG: TF32 on
  try:
    return x @ x.T  # BUG: a float32 mm under TF32
  finally:
    torch.backends.cuda.matmul.allow_tf32 = False


def good_gram(x):
  torch.backends.cuda.matmul.allow_tf32 = False
  return x @ x.T


def args():
  return (torch.randn(8, 4, generator=torch.Generator().manual_seed(0)),)
