"""Fleet API under the reference's canonical import paths
(reference: python/paddle/fluid/incubate/fleet/):

    from paddle_tpu_torch.incubate.fleet.collective import fleet
    from paddle_tpu_torch.incubate.fleet.base.role_maker import \
        PaddleCloudRoleMaker, UserDefinedRoleMaker

The implementations live in paddle_tpu_torch.parallel (fleet,
strategy, role_maker); these modules re-export them, so reference
launch scripts port with an import rename only. The parameter-server
fleet is not ported (ROADMAP item 21)."""
