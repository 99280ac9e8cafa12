"""Port of `repro.launch`: the serving launcher (`serve`), the step
builders (`steps`: train, prefill and decode, on one card or a
DeviceMesh) and the training launcher (`train`), meshes and sharding
rules (`mesh`, `sharding`), the cost analysis of one rank's program
(`hlo_analysis`), the dry run and its tables (`dryrun`, `report`),
co-design rates (`roofline`), the compile service and the fleet."""
