from navierstokes_tpu_torch.scenarios.cli import main

raise SystemExit(main())
