from suffix_torch.cli import main

raise SystemExit(main())
