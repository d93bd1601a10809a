"""The parameter-server transport of the port (`paddle_tpu.distributed.ps`).

  rpc.py — the fabric the serving fleet's verbs ride; the sparse and
           graph tables behind PULL/PUSH/GSAMPLE/GFEAT/GDEGREE are
           ROADMAP A.13
"""
